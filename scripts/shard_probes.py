"""The sharded train step on four distinct cards.  Run from the
repository root on a machine with four CUDA cards:

    PYTHONPATH=src python3 scripts/shard_probes.py [ep|qwen|serve]

``ep`` (the default): arctic-480b's full-width layer (1 layer, 14.07 B
f32 parameters, batch 8 x 512) and jamba-v0.1-52b's full-width period
(8 layers, 13.30 B, 8 x 512, or 4 x 512 where 8 rows run out of
memory), each trained by the sharded step on a
(2, 2) ('data', 'model') mesh over cuda:0..3: the experts placed by
``ctx.ep_axes`` ('2d': experts over the data axis, their d_ff over the
model axis), attention's heads, Mamba's d_inner and the FFNs' widths
split.  Neither model's training state (~225 and ~213 GB) fits one card.
Per model: the first batch's loss, ce and aux by the unsharded forward
on cuda:0 in the same two token groups (``factory.loss_parts(...,
moe_groups=2)`` under no_grad; the whole model alone there, before the
sharded runs), then the sharded steps twice from the same seed.  Prints
each card's name and power limit first, then per run the step walls,
tokens/s, each card's peak memory and stored expert bytes, K3' launches
a step and the profiled step's idle share; holds the first step's loss,
ce and aux within EP_LOSS_TOL of the unsharded forward's, the two runs'
metrics equal and their stored tensors bit-identical (an exact 128-bit
digest of every stored tensor on its card: two int64 sums mod 2^64 of
its bits, plain and position-weighted), K3' at 2 launches and 1
backward call per attention call a step, and exits non-zero if a check
fails.

``qwen``: chip_smoke.py's phase z on four distinct cards, beside the
same phase with every position on the first card: qwen2-vl-2b whole on
phase z's meshes, 8 x 512 on (2, 2) and 4 x 1024 on (1, 8) through
seqpar_attention, the four-card metrics held to the repeated card's
within phase z's limits.

``serve``: jamba-v0.1-52b whole (all 32 layers, 4 periods, the published
widths: 51.6 B f32 parameters, 206 GB) served on a (2, 2) mesh over
cuda:0..3 (models/sharded.py): ``factory.init_placed`` draws the weights
on cuda:0 one block or period sublayer at a time and places each part
before the next is drawn (the experts '2d': 8 experts a data row, half
their d_ff a card), so no card ever holds the whole model; token prompts
8 x 512, 32 greedy tokens.  Run twice from the same seed, the two runs'
tokens and prefill logits (a digest of their bits) must be identical.
The same code on jamba cut to one period (8 layers at full width, 13.3 B
parameters, which cuda:0 holds whole) is held against the unsharded
prefill and decode on cuda:0 in the same two token groups: prefill
logits within SERVE_LOGIT_TOL of their largest magnitude, tokens equal.
Prints per run each card's peak memory and stored expert bytes, the
prefill's seconds, decode ms a step, tokens/s and K3' launches per
prefill (4 attention layers x 4 positions), and exits non-zero if a
check fails.
"""
import dataclasses
import gc
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as CS  # noqa: E402  (sets CUBLAS_WORKSPACE_CONFIG)
from repro_torch.kernels.flash_attention import kernel as FA  # noqa: E402

N_CARDS = 4
# (arch, layers, batches) at the published widths, trained on EP_MESH at
# rows of EP_SEQ tokens: the first batch of the list, or where a card runs
# out of memory the next (jamba's period at 8 rows reckons ~75 GiB a card
# with the gradients of two data positions' expert reads side by side)
EP_CASES = (("arctic-480b", 1, (8,)), ("jamba-v0.1-52b", 8, (8, 4)))
EP_MESH = (2, 2)
EP_SEQ = 512
EP_LOSS_TOL = 1e-5
EP_STEPS = 3


def state_digests(state):
    """{(kind, name, device, block): digest} of every stored tensor of a
    sharded state: its parameters' and both moments'."""
    out = {}
    for kind, tree in (("p", state["placed"]), ("m", state["opt"]["m"]),
                       ("v", state["opt"]["v"])):
        for name, sh in tree.items():
            for dev, items in sh.stores.items():
                if dev in sh.wholes:
                    items = [(None, sh.wholes[dev])]
                for blk, t in items:
                    out[kind, name, str(dev), blk] = CS.digest(torch, t)
    return out


def stored_bytes(state, experts_only):
    """{device: the bytes it stores of the parameters} (of the expert
    leaves only with ``experts_only``)."""
    from repro_torch.parallelism.sharding import is_expert_leaf
    out = {}
    for name, sh in state["placed"].items():
        if experts_only and not is_expert_leaf(name):
            continue
        for dev, items in sh.stores.items():
            ts = [sh.wholes[dev]] if dev in sh.wholes else [t for _, t in
                                                           items]
            out[str(dev)] = out.get(str(dev), 0) + sum(
                t.numel() * t.element_size() for t in ts)
    return out


def ep_probe(arch, n_layers, devices, batch):
    """One model of EP_CASES at ``batch`` rows: the unsharded forward on
    ``devices[0]``, then the sharded steps twice on EP_MESH over
    ``devices``; returns its readings."""
    from repro_torch.configs import ShapeSpec, get_config
    from repro_torch.data.pipeline import make_batch_np, to_device
    from repro_torch.launch.mesh import make_ctx, make_train_mesh
    from repro_torch.models import factory
    from repro_torch.train import train_step as TS
    from repro_torch.train.optimizer import OptConfig

    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    dev = devices[0]
    cards = sorted({d.index or 0 for d in devices})
    shape = ShapeSpec("ep", EP_SEQ, batch, "train")
    opt_cfg = OptConfig(**CS.TRAIN_OPT)
    dp = EP_MESH[0]
    out = {"cfg": cfg, "runs": [], "batch": batch}

    def fresh():
        model = factory.init_params(0, cfg, device=dev)
        CS.jitter_constants(torch, model, 1)
        return model

    # the unsharded forward of the first batch, the whole model on cuda:0
    t0 = time.perf_counter()
    model = fresh()
    out["n_params"] = sum(p.numel() for p in model.parameters())
    data = to_device(make_batch_np(cfg, shape, CS.TRAIN_DATA_SEED, 0), dev)
    with torch.no_grad(), TS.deterministic(dev):
        _, m = factory.combine_parts([factory.loss_parts(
            model, data, cfg=cfg, moe_groups=dp)], cfg=cfg)
    out["unsharded"] = {k: float(x) for k, x in m.items()}
    out["unsharded_s"] = time.perf_counter() - t0
    del model, data, m
    gc.collect()
    torch.cuda.empty_cache()
    calls = CS.kernel_calls(cfg, EP_MESH, EP_SEQ)
    for _ in range(2):
        gc.collect()
        for i in cards:
            with torch.cuda.device(i):
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(i)
        ctx = make_ctx(make_train_mesh(EP_MESH, devices=devices))
        t0 = time.perf_counter()
        state = TS.init_train_state(fresh(), cfg, opt_cfg, ctx=ctx)
        CS.sync_cards(torch)
        run = {"init_s": time.perf_counter() - t0,
               "experts": stored_bytes(state, True),
               "stored": stored_bytes(state, False)}
        step_fn = TS.make_train_step(cfg, opt_cfg, ctx)
        run["rows"] = CS.train_steps(torch, step_fn, state, cfg, shape, dev,
                                     FA.flash_attention,
                                     FA.flash_attention_bwd, 0, EP_STEPS)
        run["peak"] = {i: torch.cuda.max_memory_allocated(i) for i in cards}
        run["digests"] = state_digests(state)
        b = to_device(make_batch_np(cfg, shape, CS.TRAIN_DATA_SEED,
                                    EP_STEPS), dev)
        events, wall = CS.profiled(torch, lambda: step_fn(state, b),
                                   host=False)
        CS.check(events, f"{arch}: the profile caught no device activity")
        run["profile"] = {"wall": wall,
                          "busy": sum(us for _, us in events) / 1e6,
                          "n": len(events)}
        out["runs"].append(run)
        del state, step_fn, b
    out["calls"] = calls
    return out


# the serving probe: jamba-v0.1-52b on SERVE_MESH over four cards
SERVE_ARCH = "jamba-v0.1-52b"
SERVE_MESH = (2, 2)
SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 8, 512, 32
SERVE_PERIOD_LAYERS = 8          # the one-period model held to one card
SERVE_LOGIT_TOL = 1e-4           # of the largest prefill logit
SERVE_SEED = 2029


def serve_once(cfg, served, ctx, prompts, dev):
    """A prefill and SERVE_NEW - 1 greedy decode steps, unsharded (``ctx``
    None: ``served`` the model on ``dev``, the MoE layers in the mesh's
    token groups) or on a mesh (``served`` a ``PlacedModel``); returns its
    readings, the prefill logits gathered on ``dev``."""
    from repro_torch.models import factory, sharded
    from repro_torch.models.layers.moe import moe_groups
    from repro_torch.parallelism import sharding

    dp = SERVE_MESH[0]
    b, s = prompts.shape
    if ctx is None:
        kw = {"moe_groups": moe_groups(dp, b * s, cfg.moe.top_k)}
        step_kw = {"moe_groups": moe_groups(dp, b, cfg.moe.top_k)}

        def greedy(lg):
            return torch.argmax(lg, -1).to(torch.int32)[:, None]

        def whole(lg):
            return lg
    else:
        kw = step_kw = {"ctx": ctx}
        greedy = sharded.greedy

        def whole(lg):
            return sharding.gather(lg, dev)

    FA.flash_attention.launches = 0
    CS.sync_cards(torch)
    t0 = time.perf_counter()
    logits, cache = factory.prefill(served, {"tokens": prompts}, cfg=cfg,
                                    max_len=s + SERVE_NEW, **kw)
    CS.sync_cards(torch)
    out = {"prefill_s": time.perf_counter() - t0,
           "launches": FA.flash_attention.launches}
    out["logits"] = whole(logits)
    out["digest"] = CS.digest(torch, out["logits"])
    toks = [greedy(logits)]
    t0 = time.perf_counter()
    for _ in range(SERVE_NEW - 1):
        logits, cache = factory.decode(served, cache, {"tokens": toks[-1]},
                                       cfg=cfg, **step_kw)
        toks.append(greedy(logits))
    CS.sync_cards(torch)
    decode_s = time.perf_counter() - t0
    out.update(tokens=torch.cat(toks, dim=1).cpu(),
               step_ms=decode_s * 1e3 / (SERVE_NEW - 1),
               tokens_s=b * (SERVE_NEW - 1) / decode_s)
    return out


def serve_probe(devices):
    """The serving probe (see the module's docstring): returns its
    readings."""
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_ctx, make_train_mesh
    from repro_torch.models import factory

    full = get_config(SERVE_ARCH)
    period = dataclasses.replace(full, n_layers=SERVE_PERIOD_LAYERS)
    dev = devices[0]
    cards = sorted({d.index or 0 for d in devices})
    gen = torch.Generator(device=dev).manual_seed(SERVE_SEED)
    prompts = torch.randint(0, full.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                            generator=gen, dtype=torch.int32, device=dev)
    ctx = make_ctx(make_train_mesh(SERVE_MESH, devices=devices))
    out = {"runs": []}

    def fresh():
        gc.collect()
        for i in cards:
            with torch.cuda.device(i):
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(i)

    # one period: the unsharded serving on cuda:0, then the same weights
    # drawn and placed part by part on the mesh
    fresh()
    t0 = time.perf_counter()
    model = factory.init_params(0, period, device=dev)
    out["period_params"] = sum(p.numel() for p in model.parameters())
    with torch.no_grad():
        out["period_unsharded"] = serve_once(period, model, None, prompts,
                                             dev)
    out["period_unsharded"]["init_s"] = time.perf_counter() - t0
    del model
    fresh()
    pm = factory.init_placed(0, period, ctx)
    out["period_sharded"] = serve_once(period, pm, ctx, prompts, dev)
    del pm
    # the whole model, twice
    for _ in range(2):
        fresh()
        t0 = time.perf_counter()
        pm = factory.init_placed(0, full, ctx)
        CS.sync_cards(torch)
        init_s = time.perf_counter() - t0
        state = {"placed": pm.placed}
        run = serve_once(full, pm, ctx, prompts, dev)
        run.update(init_s=init_s, experts=stored_bytes(state, True),
                   stored=stored_bytes(state, False),
                   peak={i: torch.cuda.max_memory_allocated(i)
                         for i in cards},
                   n_params=sum(int(np.prod(sh.shape))
                                for sh in pm.placed.values()))
        out["runs"].append(run)
        del pm, state
    out["cfg"], out["period"] = full, period
    out["calls"] = CS.kernel_calls(full, SERVE_MESH, SERVE_PROMPT)
    out["period_calls"] = CS.kernel_calls(period, SERVE_MESH, SERVE_PROMPT)
    return out


def serve_report(r, card):
    """Print the serving probe's lines and hold its checks."""
    c = r["cfg"]
    tag = f"[shard probe serve] {c.name}"
    u, p = r["period_unsharded"], r["period_sharded"]
    logit_err = float((p["logits"] - u["logits"]).abs().max()
                      / u["logits"].abs().max())
    same = bool(torch.equal(p["tokens"], u["tokens"]))
    print(f"{tag} cut to {r['period'].n_layers} layers (one period, "
          f"{r['period_params']} f32 parameters) at the published widths, "
          f"prompts {SERVE_BATCH} x {SERVE_PROMPT}, {SERVE_NEW} greedy "
          f"tokens, on {card}: unsharded on cuda:0 in {SERVE_MESH[0]} token "
          f"groups: prefill {u['prefill_s']:.3f} s, decode "
          f"{u['step_ms']:.2f} ms a step = {u['tokens_s']:.1f} tokens/s, "
          f"K3' {u['launches']} per prefill; on a {SERVE_MESH} mesh over "
          f"cuda:0..{N_CARDS - 1} (init_placed): prefill "
          f"{p['prefill_s']:.3f} s, decode {p['step_ms']:.2f} ms a step = "
          f"{p['tokens_s']:.1f} tokens/s, K3' {p['launches']} per prefill "
          f"(expected {r['period_calls']}); prefill logits within "
          f"{logit_err:.3e} of their largest magnitude (limit "
          f"{SERVE_LOGIT_TOL}), tokens equal {same}", flush=True)
    for i, run in enumerate(r["runs"]):
        print(f"{tag} whole ({c.n_layers} layers, {run['n_params']} f32 "
              f"parameters), run {i + 1} on a {SERVE_MESH} ('data', "
              f"'model') mesh over cuda:0..{N_CARDS - 1}, prompts "
              f"{SERVE_BATCH} x {SERVE_PROMPT}, {SERVE_NEW} greedy tokens, "
              f"on {card} each: drawn and placed part by part in "
              f"{run['init_s']:.1f} s; prefill {run['prefill_s']:.3f} s, "
              f"decode {run['step_ms']:.2f} ms a step = "
              f"{run['tokens_s']:.1f} tokens/s; K3' launches per prefill "
              f"{run['launches']} (expected {r['calls']}); peak device "
              f"memory GiB by card {gib(run['peak'])}; stored expert GiB by "
              f"device {gib(run['experts'])} of all stored parameter GiB "
              f"{gib(run['stored'])}; prefill logits digest "
              f"{run['digest']}; tokens of row 0 "
              f"{run['tokens'][0].tolist()}", flush=True)
    a, b = r["runs"]
    identical = bool(torch.equal(a["tokens"], b["tokens"])
                     and a["digest"] == b["digest"])
    print(f"{tag}: the two whole runs identical (tokens and prefill "
          f"logits' bits): {identical}", flush=True)
    CS.check(logit_err <= SERVE_LOGIT_TOL and same,
             f"{c.name} one period: the mesh departs from cuda:0 alone: "
             f"logits {logit_err}, tokens equal {same}")
    CS.check(p["launches"] == r["period_calls"]
             and all(run["launches"] == r["calls"] for run in r["runs"]),
             f"{c.name}: K3' launches per prefill {p['launches']}, "
             f"{[run['launches'] for run in r['runs']]}; expected "
             f"{r['period_calls']}, {r['calls']}")
    CS.check(identical, f"{c.name}: two whole runs differ")
    CS.check(all(np.isfinite(run["logits"].cpu().numpy()).all()
                 for run in r["runs"]), f"{c.name}: logits not finite")


def gib(by):
    """{key: bytes} in GiB, to 3 places."""
    return {k: round(v / 2**30, 3) for k, v in by.items()}


def ep_report(r, card):
    """Print one model's lines and hold its checks."""
    c = r["cfg"]
    tag = f"[shard probe] {c.name}"
    u = r["unsharded"]
    print(f"{tag} ({c.n_layers} layers at the published widths, d_model "
          f"{c.d_model}, {c.moe.n_experts} experts of d_ff "
          f"{c.moe.d_ff_expert} top-{c.moe.top_k}; {r['n_params']} f32 "
          f"parameters): the unsharded forward of the first batch on "
          f"cuda:0 in {EP_MESH[0]} token groups: loss {u['loss']:.7f}, ce "
          f"{u['ce']:.7f}, aux {u['aux']:.7f} ({r['unsharded_s']:.1f} s "
          f"with the draw), on {card}", flush=True)
    for i, run in enumerate(r["runs"]):
        walls = [x["wall"] for x in run["rows"]]
        step_s = float(np.median(walls[1:]))
        p = run["profile"]
        print(f"{tag}, sharded run {i + 1} on a {EP_MESH} ('data', "
              f"'model') mesh over cuda:0..{N_CARDS - 1}, batch {r['batch']} "
              f"x {EP_SEQ} ({r['batch'] // EP_MESH[0]} rows a data position),"
              f" AdamW {CS.TRAIN_OPT}, deterministic kernels, on {card} "
              f"each: init {run['init_s']:.1f} s; step {step_s:.3f} s "
              f"(median of steps 1-{EP_STEPS - 1}: "
              f"{', '.join(f'{x:.3f}' for x in walls[1:])}; step 0 "
              f"{walls[0]:.3f} s) = {r['batch'] * EP_SEQ / step_s:.1f} "
              f"tokens/s; peak device memory GiB by card {gib(run['peak'])}"
              f"; stored expert GiB by device {gib(run['experts'])} of all "
              f"stored parameter GiB {gib(run['stored'])}"
              f"; per step K3' forward launches "
              f"{[x['fwd'] for x in run['rows']]}, backward calls "
              f"{[x['bwd'] for x in run['rows']]}; loss "
              f"{[round(x['loss'], 7) for x in run['rows']]}, ce "
              f"{[round(x['ce'], 7) for x in run['rows']]}, aux "
              f"{[round(x['aux'], 7) for x in run['rows']]}, grad_norm "
              f"{[round(x['grad_norm'], 6) for x in run['rows']]}; profile "
              f"of one more step (device activity only): wall "
              f"{p['wall']:.3f} s, device busy {p['busy']:.4f} s summed "
              f"over the cards ({p['n']} activities; idle share "
              f"{1 - p['busy'] / (len(run['peak']) * p['wall']):.4f})",
              flush=True)
    first = r["runs"][0]["rows"][0]
    rel = {k: abs(first[k] - u[k]) / (abs(u[k]) or 1.0)
           for k in ("loss", "ce", "aux")}
    keys = ("loss", "ce", "aux", "grad_norm")
    rows_equal = all({k: a[k] for k in keys} == {k: b[k] for k in keys}
                     for a, b in zip(*(run["rows"] for run in r["runs"])))
    d1, d2 = (run["digests"] for run in r["runs"])
    differ = sorted(str(k[:3]) for k in d1 if d1[k] != d2.get(k))
    print(f"{tag}: the first sharded step against the unsharded forward: "
          f"relative difference loss {rel['loss']:.2e}, ce {rel['ce']:.2e}, "
          f"aux {rel['aux']:.2e} (limit {EP_LOSS_TOL}); the two sharded "
          f"runs: metrics equal {rows_equal}, stored tensors bit-identical "
          f"{not differ} ({len(d1)} digested, {len(differ)} differ)",
          flush=True)
    for run in r["runs"]:
        for x in run["rows"]:
            CS.check(np.isfinite(x["loss"]) and np.isfinite(x["grad_norm"]),
                     f"{c.name} step {x['step']}: not finite")
            CS.check(x["fwd"] == 2 * r["calls"] and x["bwd"] == r["calls"],
                     f"{c.name} step {x['step']}: {x['fwd']} K3' launches "
                     f"and {x['bwd']} backward calls; {r['calls']} a "
                     "forward")
        CS.check(all(v > 0 for v in run["experts"].values()),
                 f"{c.name}: a card stores no expert")
    CS.check(max(rel.values()) <= EP_LOSS_TOL,
             f"{c.name}: the sharded step's first loss departs from the "
             f"unsharded forward's: {rel}")
    CS.check(rows_equal and not differ,
             f"{c.name}: two sharded runs differ: {differ[:5]}")


def qwen_probe():
    """chip_smoke.py's phase z on four cards against one card repeated."""
    cards = [torch.device("cuda", i) for i in range(N_CARDS)]
    card = CS.card_line()
    seq_mesh, seq_batch, seq_len, _ = CS.SHARD_SEQPAR
    per_card = seq_mesh[0] * seq_mesh[1] // N_CARDS
    cases = [({}, cards),
             (dict(meshes=(seq_mesh,), batch=seq_batch, seq=seq_len),
              [c for c in cards for _ in range(per_card)])]
    for kw, spread in cases:
        runs = {}
        for name, devices in (("four cards", spread),
                              ("one card repeated",
                               [cards[0]] * len(spread))):
            print(f"[shard probe] {name}", flush=True)
            runs[name] = CS.phase_shard_train(torch, FA, devices=devices,
                                              **kw)
            CS.report_shard_train(runs[name], card, name)
        for mesh in runs["four cards"]["meshes"]:
            four, one = (runs[n]["runs"][mesh, "sharded"]["rows"]
                         for n in runs)
            rel = {k: max(abs(a[k] - b[k]) / (abs(b[k]) or 1.0)
                          for a, b in zip(four, one))
                   for k in ("loss", "ce", "grad_norm")}
            print(f"[shard probe] {mesh}: four cards against one card "
                  f"repeated: worst relative difference {rel}", flush=True)
            CS.check(max(rel["loss"], rel["ce"]) <= CS.MOE_TRAIN_METRIC_TOL
                     and rel["grad_norm"] <= CS.MOE_TRAIN_GRAD_TOL,
                     f"{mesh}: four cards depart from one card repeated: "
                     f"{rel}")


def main(argv):
    which = argv[0] if argv else "ep"
    if which not in ("ep", "qwen", "serve"):
        print(f"shard_probes: unknown probe {which!r} (ep, qwen or serve)",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < N_CARDS:
        print(f"shard_probes: needs {N_CARDS} CUDA cards, have "
              f"{torch.cuda.device_count()}", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout, flush=True)
    FA.build()
    FA.build_bwd()
    for i in range(N_CARDS):       # the allocator's stats need a context
        torch.zeros(1, device=torch.device("cuda", i))
    if which == "qwen":
        qwen_probe()
        return 0
    if which == "serve":
        t0 = time.perf_counter()
        serve_report(serve_probe([torch.device("cuda", i)
                                  for i in range(N_CARDS)]), CS.card_line())
        print(f"[shard probe serve] all checks passed in "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
        return 0
    card = CS.card_line()
    t0 = time.perf_counter()
    devices = [torch.device("cuda", i) for i in range(N_CARDS)]
    for arch, n_layers, batches in EP_CASES:
        t = time.perf_counter()
        for batch in batches:
            try:
                r = ep_probe(arch, n_layers, devices, batch)
                break
            except torch.cuda.OutOfMemoryError as e:
                if batch == batches[-1]:
                    raise
                why = str(e).splitlines()[0]
            # outside the handler, so that the failed run's frames are gone
            print(f"[shard probe] {arch} at {batch} x {EP_SEQ}: out of "
                  f"memory ({why}); the next batch", flush=True)
            gc.collect()
            for i in range(N_CARDS):
                with torch.cuda.device(i):
                    torch.cuda.empty_cache()
        ep_report(r, card)
        gc.collect()
        torch.cuda.empty_cache()
        print(f"[shard probe] {arch}: {time.perf_counter() - t:.1f} s",
              flush=True)
    print(f"[shard probe] all checks passed in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
