#!/usr/bin/env python3
"""Smoke run of dglke_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card, the torch and CUDA versions, and the nvcc build of the
     kernels in dglke_tpu_torch/ops/csrc/rows.cu, timed;
  2. each kernel against its plain PyTorch version at the flagship shapes
     (FB15k width: 14,951 x 400 entity table, 1,345 x 400 relation table,
     3,000 entity ids and 1,000 relation ids per step), with its time, the
     plain version's time, one PyTorch call as yardstick, and its bound;
  3. the main path: dglke_tpu_torch.cli.train.main on an FB15k-shaped
     synthetic dataset with the flagship flags and --test, with the launch
     counts of both kernels read around that run only; then two flagship
     steps on the card against the CPU's plain path; then the time of a
     flagship step on the host clock, and under torch.profiler the
     device's busy share and the kernels by device time;
  4. the planted TransE_l2 quality gate on the card (MRR >= 0.85);
  5. the kernel summary: a `kernels:` line, one JSON line of per-kernel
     numbers, the card's name and power limit, and the result line.

Everything it writes goes under build/chip_smoke/ and is removed at the
end; the kernels are built under build/dglke_tpu_torch/.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and fp32 outside the
# tensor cores; at the card's full 700 W power limit.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

N_ENT, N_REL, DIM = 14951, 1345, 400
BATCH, NEG = 1000, 200
N_ENT_IDS = 2 * BATCH + (BATCH // NEG) * NEG      # [h | t | neg] = 3,000
LR = 0.25

# Stated tolerances.  K1 moves bits: exact.  K2 sums each id's segment in
# a fixed order, the plain version adds per occurrence:
# fp32 within rtol 1e-5 / atol 1e-6.  With a bf16 table both sum each
# touched row in fp32 and round once: within one bf16 ulp (plus atol 1e-6,
# for fp32 sums that cancel near zero).
K2_RTOL, K2_ATOL = 1e-5, 1e-6


def fail(msg: str) -> None:
    raise RuntimeError(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def call_ms(fn, iters: int = 200, warmup: int = 20) -> float:
    """Mean time of one fn() call, back to back, on CUDA events: what a
    caller waits, host launch overhead included (inputs stay warm in L2, as
    they are inside a train step)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _kernel_events(prof):
    import torch
    return [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def device_ms(fn, iters: int = 50) -> float:
    """Device time of one fn() call: the sum of the kernels it runs, from a
    torch.profiler trace of `iters` calls (host overhead excluded)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in _kernel_events(prof))
    if us <= 0:
        fail("torch.profiler recorded no device time")
    return us / iters / 1e3


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bf16_ulps(got, want, atol: float = K2_ATOL) -> float:
    """Largest |got - want| in units of (one bf16 ulp of `want` + atol);
    at most 1 means within the stated bf16 tolerance."""
    import torch
    want = want.float()
    mag = torch.clamp(want.abs(), min=2.0 ** -126)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return float(torch.max((got.float() - want).abs() / (ulp + atol)))


# ---------------------------------------------------------------------------
# Phase 1


def phase_build():
    import torch
    from dglke_tpu_torch.ops import rows
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    rows.load_library()
    print(f"kernel build + load: {time.time() - t0:.2f} s")
    for line in rows.build_log.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            print(f"  nvcc: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 2


def phase_kernels():
    """Each kernel against its plain version at the flagship shapes;
    returns the per-kernel numbers for the JSON line."""
    import torch
    from dglke_tpu_torch.ops import rows
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(0)
    table = torch.randn((N_ENT, DIM), generator=gen, device=dev) * 0.05
    rel_table = torch.randn((N_REL, DIM), generator=gen, device=dev) * 0.05
    ent_ids = torch.randint(0, N_ENT, (N_ENT_IDS,), generator=gen,
                            device=dev, dtype=torch.int32)
    rel_ids = torch.randint(0, N_REL, (BATCH,), generator=gen, device=dev,
                            dtype=torch.int32)
    n_unique = int(torch.unique(ent_ids).numel())
    n_rel_unique = int(torch.unique(rel_ids).numel())
    print(f"entity ids: {N_ENT_IDS} ({n_unique} distinct); relation ids: "
          f"{BATCH} ({n_rel_unique} distinct)")

    # -- K1: row gather ------------------------------------------------------
    for name, tab, ids in (("entity fp32", table, ent_ids),
                           ("entity bf16", table.to(torch.bfloat16), ent_ids),
                           ("relation fp32", rel_table, rel_ids)):
        got = rows.gather_rows(tab, ids, DIM)
        want = rows.gather_rows_plain(tab, ids, DIM)
        torch.cuda.synchronize()
        if got.dtype != torch.float32 or not torch.equal(got, want):
            fail(f"K1 gather_rows {name}: differs from its plain version")
        print(f"K1 gather_rows {name} [{ids.numel()} ids]: exact")
    k1_err = float((rows.gather_rows(table, ent_ids, DIM)
                    - rows.gather_rows_plain(table, ent_ids, DIM))
                   .abs().max())
    k1 = {n: (device_ms(f), call_ms(f)) for n, f in (
        ("kernel", lambda: rows.gather_rows(table, ent_ids, DIM)),
        ("plain", lambda: rows.gather_rows_plain(table, ent_ids, DIM)),
        ("index_select", lambda: torch.index_select(table, 0, ent_ids)))}
    k1_bytes = N_ENT_IDS * 4 + n_unique * DIM * 4 + N_ENT_IDS * DIM * 4
    k1_bound, k1_by = bound_ms(k1_bytes, 0)
    bf = table.to(torch.bfloat16)
    k1_bf = device_ms(lambda: rows.gather_rows(bf, ent_ids, DIM))
    k1_rel = device_ms(lambda: rows.gather_rows(rel_table, rel_ids, DIM))
    print(f"K1 gather_rows entity fp32, device ms (ms per call with host "
          f"overhead): " + ", ".join(f"{n} {d:.4f} ({c:.4f})"
                                     for n, (d, c) in k1.items())
          + f"; bound {k1_bound:.4f} ({k1_by}, {k1_bytes / 1e6:.2f} MB); "
          f"kernel on entity bf16 {k1_bf:.4f}, on relation fp32 "
          f"[{BATCH} ids] {k1_rel:.4f}")

    # -- K2: row-sparse Adagrad write-back -------------------------------------
    grads = torch.randn((N_ENT_IDS, DIM), generator=gen, device=dev) * 0.1
    rel_grads = torch.randn((BATCH, DIM), generator=gen, device=dev) * 0.1
    ss0 = torch.rand((N_ENT,), generator=gen, device=dev)
    rel_ss0 = torch.rand((N_REL,), generator=gen, device=dev)

    def k2_pair(emb0, state0, ids, g):
        ek, sk = emb0.clone(), state0.clone()
        ep, sp = emb0.clone(), state0.clone()
        rows.sparse_adagrad_rows(ek, sk, ids, g, LR)
        rows.sparse_adagrad_plain(ep, sp, ids, g, LR)
        torch.cuda.synchronize()
        return (ek, sk), (ep, sp)

    k2_err = 0.0
    for name, emb0, st0, ids, g in (
            ("entity", table, ss0, ent_ids, grads),
            ("relation", rel_table, rel_ss0, rel_ids, rel_grads)):
        (ek, sk), (ep, sp) = k2_pair(emb0, st0, ids, g)
        err = 0.0
        for what, a, b in (("emb", ek, ep), ("state_sum", sk, sp)):
            if not torch.allclose(a, b, rtol=K2_RTOL, atol=K2_ATOL):
                fail(f"K2 sparse_adagrad_rows {name} {what}: max |diff| "
                     f"{float((a - b).abs().max())} outside rtol {K2_RTOL} "
                     f"atol {K2_ATOL}")
            err = max(err, float((a - b).abs().max()))
        k2_err = max(k2_err, err)
        (ek2, sk2), _ = k2_pair(emb0, st0, ids, g)
        if not (torch.equal(ek, ek2) and torch.equal(sk, sk2)):
            fail(f"K2 sparse_adagrad_rows {name}: two runs differ")
        print(f"K2 sparse_adagrad_rows {name} fp32 [{ids.numel()} ids]: "
              f"within rtol {K2_RTOL} / atol {K2_ATOL} of plain "
              f"(max |diff| {err:.3g}); two runs bit-identical")

    # bf16 entity table: both versions sum each row in fp32, round once
    (ek, sk), (ep, sp) = k2_pair(table.to(torch.bfloat16), ss0, ent_ids,
                                 grads)
    ulps = bf16_ulps(ek, ep)
    if ulps > 1.0 or not torch.allclose(sk, sp, rtol=K2_RTOL, atol=K2_ATOL):
        fail(f"K2 sparse_adagrad_rows entity bf16: {ulps:.3f} times the "
             f"bound of one bf16 ulp + atol {K2_ATOL} from the plain version")
    print(f"K2 sparse_adagrad_rows entity bf16: within one bf16 ulp + atol "
          f"{K2_ATOL} of plain (worst {ulps:.3f} of that bound)")

    # scatter_add_rows: the TPU kernel's own function, on the same core
    tk, tp = table.clone(), table.clone()
    rows.scatter_add_rows(tk, ent_ids, grads)
    rows.scatter_add_plain(tp, ent_ids, grads)
    if not torch.allclose(tk, tp, rtol=K2_RTOL, atol=K2_ATOL):
        fail("K2 scatter_add_rows entity: differs from its plain version")
    print("K2 scatter_add_rows entity fp32: within rtol/atol of plain")

    emb_t, st_t = table.clone(), ss0.clone()
    ids64 = ent_ids.long()
    k2 = {n: (device_ms(f), call_ms(f)) for n, f in (
        ("kernel", lambda: rows.sparse_adagrad_rows(
            emb_t, st_t, ent_ids, grads, LR)),
        ("plain", lambda: rows.sparse_adagrad_plain(
            emb_t, st_t, ent_ids, grads, LR)),
        ("index_add_", lambda: emb_t.index_add_(0, ids64, grads)))}
    k2_sort = device_ms(lambda: torch.sort(ent_ids, stable=True))
    rel_t, rst_t = rel_table.clone(), rel_ss0.clone()
    k2_rel = device_ms(lambda: rows.sparse_adagrad_rows(
        rel_t, rst_t, rel_ids, rel_grads, LR))
    k2_bytes = (N_ENT_IDS * 4 + N_ENT_IDS * DIM * 4
                + 2 * n_unique * DIM * 4 + 2 * n_unique * 4)
    k2_ops = 3 * N_ENT_IDS * DIM + 3 * n_unique * DIM
    k2_bound, k2_by = bound_ms(k2_bytes, k2_ops)
    print(f"K2 sparse_adagrad_rows entity fp32, device ms (ms per call with "
          f"host overhead): " + ", ".join(f"{n} {d:.4f} ({c:.4f})"
                                          for n, (d, c) in k2.items())
          + f"; the kernel's time includes the id sort, alone "
          f"{k2_sort:.4f}; bound {k2_bound:.4f} ({k2_by}, "
          f"{k2_bytes / 1e6:.2f} MB); kernel on relation [{BATCH} ids] "
          f"{k2_rel:.4f}")

    src = "dglke_tpu_torch/ops/csrc/rows.cu"
    return [
        {"name": "gather_rows", "route": "cuda", "source": src,
         "replaces": "dglke_tpu/ops/pallas/rows.py:89",
         "launches": None, "max_abs_err": k1_err, "ms": k1["kernel"][0],
         "plain_ms": k1["plain"][0], "bound_ms": k1_bound,
         "bound_by": k1_by, "library_ms": k1["index_select"][0]},
        {"name": "sparse_adagrad_rows", "route": "cuda", "source": src,
         "replaces": "dglke_tpu/ops/pallas/rows.py:227",
         "launches": None, "max_abs_err": k2_err, "ms": k2["kernel"][0],
         "plain_ms": k2["plain"][0], "bound_ms": k2_bound,
         "bound_by": k2_by, "library_ms": k2["index_add_"][0]},
    ]


# ---------------------------------------------------------------------------
# Phase 3


def _write_fb15k_shaped(path: str, n_train: int) -> None:
    """An FB15k-shaped synthetic dataset in the udd_hrt layout."""
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    ds = synthetic_dataset(n_entities=N_ENT, n_relations=N_REL,
                           n_train=n_train, n_valid=1000, n_test=2000,
                           seed=0)
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "entities.tsv"), "w") as f:
        f.writelines(f"{i}\te{i}\n" for i in range(N_ENT))
    with open(os.path.join(path, "relations.tsv"), "w") as f:
        f.writelines(f"{i}\tr{i}\n" for i in range(N_REL))
    for split in ("train", "valid", "test"):
        h, r, t = getattr(ds, split)
        np.savetxt(os.path.join(path, f"{split}.tsv"),
                   np.stack([h, r, t], axis=1), fmt="%d", delimiter="\t")


def _floats(pattern: str, text: str):
    return [float(x) for x in re.findall(pattern, text)]


def phase_main_path(steps: int = 1000):
    """dglke_tpu_torch-train on the card with the flagship flags; returns
    the launch counts of the run."""
    from dglke_tpu_torch.cli import train as train_cli
    from dglke_tpu_torch.ops import rows
    data = os.path.join(WORK, "data")
    _write_fb15k_shaped(data, n_train=300_000)
    argv = ["--model_name", "TransE_l2", "--dataset", "fb15k_shaped",
            "--data_path", data, "--format", "udd_hrt", "--data_files",
            "entities.tsv", "relations.tsv", "train.tsv", "valid.tsv",
            "test.tsv", "--hidden_dim", str(DIM), "--gamma", "19.9",
            "--lr", str(LR), "--batch_size", str(BATCH),
            "--neg_sample_size", str(NEG), "-adv", "-rc", "1e-9",
            "--max_step", str(steps), "--log_interval", str(steps // 4),
            "--batch_size_eval", "500", "--test",
            "--save_path", os.path.join(WORK, "ckpts")]
    print("main path: dglke_tpu_torch-train " + " ".join(argv))
    out = io.StringIO()
    rows.reset_launches()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    counts = dict(rows.launches)
    text = out.getvalue()
    print(text.rstrip())
    if rc != 0:
        fail(f"main path: train CLI returned {rc}")
    losses = _floats(r"average loss: (\S+)", text)
    mrr = _floats(r"\[0\]Test average MRR: (\S+)", text)
    train_s = _floats(r"training takes (\S+) seconds", text)
    eval_s = _floats(r"\[0\]Test takes (\S+) seconds", text)
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"main path: loss not finite: {losses}")
    if len(mrr) != 1 or not 0.0 < mrr[0] <= 1.0:
        fail(f"main path: test MRR {mrr} outside (0, 1]")
    for k in ("gather_rows", "sparse_adagrad_rows"):
        if counts[k] <= 0:
            fail(f"main path: kernel {k} was never launched")
    print(f"main path: {steps} steps, {steps * BATCH / train_s[0]:.1f} "
          f"triples/s (host clock over the whole loop, first step "
          f"included), test eval {eval_s[0]:.3f} s, MRR {mrr[0]:.4f}, "
          f"last loss {losses[-1]:.4f}; launches {counts}")
    return counts


def phase_step_parity():
    """One flagship train step in each corruption direction on the card
    and on the CPU (the plain versions), from identical tables and ids:
    tables, Adagrad state and loss within rtol 1e-4 / atol 1e-5 (cuBLAS
    and the CPU sum in other orders; the first Adagrad step scales each
    gradient row to unit RMS, so it carries those differences into the
    tables at full size)."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
    cfg = KGEConfig(model_name="TransE_l2", hidden_dim=DIM, gamma=19.9,
                    lr=LR, batch_size=BATCH, neg_sample_size=NEG,
                    neg_adversarial_sampling=True, regularization_coef=1e-9)
    rng = np.random.default_rng(1)
    gpu_model = KEModel(cfg, N_ENT, N_REL, device="cuda")
    cpu_model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    arrays = state_to_numpy(gpu_model.init_state())
    state = state_from_numpy(arrays, device="cpu")
    gpu_state = state_from_numpy(arrays, device="cuda")
    for neg_head in (True, False):
        ids = [rng.integers(0, n, size).astype(np.int32) for n, size in
               ((N_ENT, BATCH), (N_REL, BATCH), (N_ENT, BATCH),
                (N_ENT, N_ENT_IDS - 2 * BATCH))]
        _, clog = cpu_model.train_step(
            state, *(torch.from_numpy(x) for x in ids), None,
            neg_head=neg_head)
        _, glog = gpu_model.train_step(
            gpu_state, *(torch.from_numpy(x).cuda() for x in ids), None,
            neg_head=neg_head)
        for what, a, b in (
                ("loss", glog["loss"], clog["loss"]),
                ("entity emb", gpu_state.entity.emb, state.entity.emb),
                ("entity state_sum", gpu_state.entity.state_sum,
                 state.entity.state_sum),
                ("relation emb", gpu_state.relation.emb,
                 state.relation.emb)):
            a = a.cpu()
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                fail(f"step parity ({'head' if neg_head else 'tail'}): "
                     f"{what} on the card differs from the CPU by "
                     f"{float((a - b).abs().max())}")
    print("step parity: two flagship steps on the card match the CPU's "
          "plain path within rtol 1e-4 / atol 1e-5")


def phase_step_profile(steps: int = 50):
    """Where a flagship train step's time goes: the host clock over
    `steps` DevicePipeline steps, then torch.profiler over the same number
    for the device's busy share and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.trainer import DevicePipeline
    cfg = KGEConfig(model_name="TransE_l2", hidden_dim=DIM, gamma=19.9,
                    lr=LR, batch_size=BATCH, neg_sample_size=NEG,
                    neg_adversarial_sampling=True, regularization_coef=1e-9)
    ds = synthetic_dataset(N_ENT, N_REL, n_train=100_000, seed=0)
    model = KEModel(cfg, N_ENT, N_REL, device="cuda")
    state = model.init_state()
    pipe = DevicePipeline(model, ds, BATCH, cfg.num_chunks * NEG, seed=0)

    def run(n):
        nonlocal state
        for _ in range(n):
            state, _ = pipe.run_step(state)
        torch.cuda.synchronize()

    run(steps)
    t0 = time.perf_counter()
    run(steps)
    step_ms = (time.perf_counter() - t0) * 1e3 / steps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(steps)
    kern = _kernel_events(prof)
    busy = sum(e.self_device_time_total for e in kern) / 1e3 / steps
    print(f"step profile: {step_ms:.4f} ms per flagship step on the host "
          f"clock ({BATCH * 1e3 / step_ms:.1f} triples/s); device busy "
          f"{busy:.4f} ms per step ({100 * busy / step_ms:.1f}%, idle "
          f"{100 - 100 * busy / step_ms:.1f}%); "
          f"{sum(e.count for e in kern) / steps:.1f} kernels per step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
              f"x{e.count / steps:.1f}  {e.key[:90]}")


# ---------------------------------------------------------------------------
# Phase 4


def phase_planted():
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import planted_dataset
    from dglke_tpu_torch.trainer import evaluate, train
    ds = planted_dataset("line", n_clusters=10)
    cfg = KGEConfig(model_name="TransE_l2", hidden_dim=32, gamma=4.0,
                    lr=0.25, batch_size=128, neg_sample_size=32,
                    max_step=2000, batch_size_eval=16, log_interval=10**9,
                    neg_adversarial_sampling=True, regularization_coef=1e-9,
                    seed=7, dataset="synthetic")
    quiet = lambda *a: None  # noqa: E731
    model, state, _ = train(cfg, ds, log=quiet)
    m = evaluate(cfg, ds, model, state, "test", log=quiet)
    if m["MRR"] < 0.85 or m["HITS@10"] < 0.99:
        fail(f"planted TransE_l2 gate failed on the card: {m}")
    print(f"planted TransE_l2 gate: MRR {m['MRR']:.4f}, HITS@10 "
          f"{m['HITS@10']:.4f} (gate MRR >= 0.85, HITS@10 >= 0.99)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 1
    from dglke_tpu_torch.ops import rows  # noqa: F401  (fails outside the repo)
    shutil.rmtree(WORK, ignore_errors=True)
    try:
        phase_build()
        kernels = phase_kernels()
        counts = phase_main_path()
        phase_step_parity()
        phase_step_profile()
        phase_planted()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    for k in kernels:
        k["launches"] = counts[k["name"]]
    print("kernels: " + ", ".join(f"{k['name']} ({k['route']}, launches "
                                  f"{k['launches']})" for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
