"""TF32 on the CPU: the card's rounding and the hand-written kernels' split
of an f32 operand into TF32 parts, and a matrix product on emulated TF32
tensor cores, shared by the flash-attention and wkv6 kernels' tests."""
import torch


def tf32(x):
    """f32 → TF32 as the card's ``cvt.rna.tf32.f32`` rounds it: the low 13
    mantissa bits rounded to nearest, ties away from zero."""
    bits = x.view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def tf32_toward_zero(x):
    """f32 → TF32 with the low 13 mantissa bits cleared."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


# the split of an f32 operand into TF32 (big, small): the kernels' (big
# rounded toward zero, small to nearest), and both to nearest
SPLITS = {"kernel": lambda x: (tf32_toward_zero(x),
                               tf32(x - tf32_toward_zero(x))),
          "nearest": lambda x: (tf32(x), tf32(x - tf32(x)))}


def tf32_mm(a, b, passes, split="kernel"):
    """a @ b on emulated TF32 tensor cores, sums in f64, result in f32: one
    pass (the operands rounded to nearest TF32) or the kernels' three (each
    operand split into TF32 big and small parts; small terms first, small
    x small dropped)."""
    if passes == 1:
        return (tf32(a).double() @ tf32(b).double()).float()
    (ab, a_s), (bb, b_s) = SPLITS[split](a), SPLITS[split](b)
    return (a_s.double() @ bb.double() + ab.double() @ b_s.double()
            + ab.double() @ bb.double()).float()
