"""The port's data pipeline (``repro_torch.data.pipeline``) against the JAX
package's: ``make_batch_np`` byte-equal for the same (seed, step) on a
token model, the vision frontend's embeds and Whisper's frames; the
``Pipeline`` hands out tensors on its device from its start step, and
drops stale prefetches when its step moves on."""
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.configs import ShapeSpec as JShapeSpec
from repro.data.pipeline import make_batch_np as jmake_batch_np
from repro_torch.configs import ShapeSpec, get_reduced
from repro_torch.data.pipeline import DataConfig, Pipeline, make_batch_np


@pytest.mark.parametrize("arch", ["codeqwen1.5-7b", "rwkv6-1.6b",
                                  "qwen2-vl-2b", "whisper-base"])
def test_make_batch_np_byte_equal(arch):
    for seed, step in ((3, 0), (3, 11), (1234, 7)):
        got = make_batch_np(get_reduced(arch), ShapeSpec("t", 16, 2, "train"),
                            seed, step)
        want = jmake_batch_np(jget_reduced(arch),
                              JShapeSpec("t", 16, 2, "train"), seed, step)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert got[k].shape == want[k].shape
            assert got[k].tobytes() == want[k].tobytes()


def test_pipeline_resumes_and_drops_stale_prefetches():
    cfg = get_reduced("codeqwen1.5-7b")
    shape = ShapeSpec("t", 8, 2, "train")
    pipe = Pipeline(cfg, shape, DataConfig(seed=5, prefetch_depth=2),
                    start_step=3, device="cpu")
    try:
        batch = next(pipe)
        want = make_batch_np(cfg, shape, 5, 3)
        for k in want:
            assert isinstance(batch[k], torch.Tensor)
            assert batch[k].device == torch.device("cpu")
            assert np.array_equal(batch[k].numpy(), want[k])
        pipe.step = 9                  # a resume further on
        batch = next(pipe)
        assert np.array_equal(batch["tokens"].numpy(),
                              make_batch_np(cfg, shape, 5, 9)["tokens"])
        assert pipe.step == 10
    finally:
        pipe.close()
