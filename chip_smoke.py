#!/usr/bin/env python3
"""Smoke run of dglke_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):
  1. the card, the torch and CUDA versions, and the nvcc builds of the
     kernel sources in dglke_tpu_torch/ops/csrc/ (one nvcc per source, all
     started together), timed;
  2. each kernel against its plain PyTorch version at the shapes its main
     path gives it, with its time, the plain version's time, one PyTorch
     call as yardstick where one computes the same function, and its bound:
     K1 and K2 at the TransE_l2 flagship shapes (FB15k width: 14,951 x 400
     entity table, 1,345 x 400 relation table, 3,000 entity ids and 1,000
     relation ids per step), K1 in its one-warp-per-row shape there; K1's
     two launch shapes exact and timed in turns across widths 256-16,384
     (the measurement behind rows.GATHER_WIDE_MIN); K3 at RESCAL's FB15k
     shapes (1,345 x 250,000 relation table, 1,000 ids, 500-wide factors)
     on its cluster route, with the cluster size chosen, the other size and
     the tiles route held to the plain version and timed in turns, the max
     active clusters, and the stock route for the same update (the gradient
     materialized, then K2); K1 on the 1 MB relation rows, both shapes and
     dtypes exact at a width that is and one that is not a multiple of 4,
     timed in three rounds beside torch.index_select; K3's routes away from
     hidden 500: the cluster route at hidden 32 and at a ragged 7 x 13
     width, each with one segment longer than the staged factors hold, and
     the tiles route at hidden 1,000;
  3. the TransE_l2 main path: dglke_tpu_torch.cli.train.main on an
     FB15k-shaped synthetic dataset with the flagship flags and --test,
     with the launch counts read around that run only and held to
     EXPECTED_LAUNCHES; then two flagship steps on the card against the
     CPU's plain path; then a flagship step on the host clock, and under
     torch.profiler the device's busy share and the kernels by device time;
  4. the RESCAL main path, the same three parts: the CLI with the flags of
     examples/fb15k.sh (hidden 500), --max_step 1000 and --test on the same
     data, its launch counts read around that run only and held to
     EXPECTED_LAUNCHES (the relation update goes through K3, never K2);
     two full-width steps on the card against the CPU; the step profile;
  5. the planted quality gate of every family on the card (MRR >= 0.85,
     HITS@10 >= 0.99, the JAX package's calibrated configs);
  6. the kernel summary: a `kernels:` line, one JSON line of per-kernel
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
from pathlib import Path

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

# The two main paths' configurations: TransE_l2 as bench.py:188-201 runs
# it, RESCAL as examples/fb15k.sh:29-31 runs it (default regularization,
# coef 2e-6 and norm 3).
TRANSE = dict(model_name="TransE_l2", hidden_dim=DIM, gamma=19.9, lr=LR,
              batch_size=BATCH, neg_sample_size=NEG,
              neg_adversarial_sampling=True, regularization_coef=1e-9)
RESCAL = dict(model_name="RESCAL", hidden_dim=500, gamma=24.0, lr=0.03,
              batch_size=BATCH, neg_sample_size=NEG,
              neg_adversarial_sampling=True, regularization_coef=2e-6,
              regularization_norm=3)
RESCAL_WIDTH = RESCAL["hidden_dim"] ** 2             # 250,000 per relation
RESCAL_EVAL_BATCH = 500
MAIN_STEPS = 1000
# Launches in each main path's run alone (1,000 steps, then the test eval):
# K1 twice per step (entity and relation rows) and 32 times in the eval; K2
# once per step for each table it updates.  RESCAL's relation update goes
# through K3 on every step and never through K2.
EXPECTED_LAUNCHES = {
    "TransE_l2": {"gather_rows": 2032, "sparse_adagrad_rows": 2000,
                  "outer_adagrad_update": 0},
    "RESCAL": {"gather_rows": 2032, "sparse_adagrad_rows": 1000,
               "outer_adagrad_update": 1000},
}

# Stated tolerances.  K1 moves bits: exact.  K2 sums each id's segment in
# a fixed order, the plain version adds per occurrence:
# fp32 within rtol 1e-5 / atol 1e-6.  With a bf16 table both sum each
# touched row in fp32 and round once: within one bf16 ulp (plus atol 1e-6,
# for fp32 sums that cancel near zero).
K2_RTOL, K2_ATOL = 1e-5, 1e-6
# K3 sums each id's segment in a fixed order and subtracts once; its plain
# version adds per occurrence (index_add_): fp32 within rtol 1e-5 / atol
# 1e-6, and two runs bit-identical.
K3_RTOL, K3_ATOL = 1e-5, 1e-6
# outer_update.cu with its phase stamps compiled in (k3_phases).
K3_STAMPED = Path(ROOT, "dglke_tpu_torch", "ops", "csrc",
                  "outer_update_stamps.cu")


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
    from dglke_tpu_torch.ops import outer_update, rows
    print(f"card: {card_line()}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"device {torch.cuda.get_device_name(0)}")
    t0 = time.time()
    rows.build_libraries(rows.SOURCE, outer_update.SOURCE, K3_STAMPED)
    rows.load_library(rows.SOURCE, rows.SIGNATURES)
    rows.load_library(outer_update.SOURCE, outer_update.SIGNATURES)
    print(f"kernel builds (in parallel) + load: {time.time() - t0:.2f} s")
    for src, log in rows.build_logs.items():
        for line in log.splitlines():
            if any(w in line for w in ("registers", "spill", "error",
                                        "warning")):
                print(f"  nvcc {src}: {line.strip()}")


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
    if rows.gather_shape(DIM) != "warp":
        fail(f"K1 at the flagship width {DIM} must keep one warp per row")
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
    print(f"K1 gather_rows entity fp32 (warp shape), device ms (ms per call "
          f"with host overhead): " + ", ".join(f"{n} {d:.4f} ({c:.4f})"
                                               for n, (d, c) in k1.items())
          + f"; bound {k1_bound:.4f} ({k1_by}, {k1_bytes / 1e6:.2f} MB), "
          f"{100 * k1_bound / k1['kernel'][0]:.1f}% of it, "
          f"{k1_bytes / k1['kernel'][0] / 1e9:.3f} TB/s; kernel on entity "
          f"bf16 {k1_bf:.4f}, on relation fp32 [{BATCH} ids] {k1_rel:.4f}")

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


def phase_gather_shapes():
    """K1's two launch shapes across widths, each exact against the plain
    version, timed in turns (warp, wide, wide, warp): the measurement
    behind rows.GATHER_WIDE_MIN.  3,000 ids into a 4,096-row fp32 table."""
    import torch
    from dglke_tpu_torch.ops import rows
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(2)
    ids = torch.randint(0, 4096, (N_ENT_IDS,), generator=gen, device=dev,
                        dtype=torch.int32)
    print(f"K1 shape sweep [{N_ENT_IDS} ids, 4,096-row fp32 table], device "
          f"ms warp / wide (threshold {rows.GATHER_WIDE_MIN}):")
    for width in (256, 512, 1024, 2048, 4096, 8192, 16384):
        table = torch.randn((4096, width), generator=gen, device=dev)
        want = rows.gather_rows_plain(table, ids, width)
        ms = {"warp": [], "wide": []}
        for shape in ("warp", "wide", "wide", "warp"):
            run = lambda s=shape: rows.launch_gather(table, ids, width, s)  # noqa: E731
            if not torch.equal(run(), want):
                fail(f"K1 {shape} shape at width {width}: differs from its "
                     f"plain version")
            ms[shape].append(device_ms(run, iters=20))
        warp, wide = (sum(v) / 2 for v in ms.values())
        print(f"  width {width}: warp {warp:.5f}, wide {wide:.5f}; chosen "
              f"{rows.gather_shape(width)}, faster "
              f"{'wide' if wide < warp else 'warp'}")
        del table, want


def k3_phases(state, ids, a, b, lr, coef, norm) -> None:
    """Where a segment's time goes on K3's cluster route: the stamped build
    of outer_update.cu (thread 0 of each CTA reads %globaltimer at six
    points of each of its first 128 segments) run on the same inputs."""
    import ctypes
    import torch
    from dglke_tpu_torch.ops import outer_update, rows
    lib = rows.load_library(K3_STAMPED, {
        **outer_update.SIGNATURES,
        "dglke_outer_stamps": ([ctypes.c_void_p, ctypes.c_void_p],
                               ctypes.c_int)})
    main_source, outer_update.SOURCE = outer_update.SOURCE, K3_STAMPED
    try:
        for _ in range(3):
            outer_update.outer_adagrad_update(state, ids, a, b, lr, coef, norm)
        torch.cuda.synchronize()
    finally:
        outer_update.SOURCE = main_source
    stamps = np.zeros((1024, 128, 6), np.uint64)
    segs = np.zeros(1024, np.uint32)
    rows.check_launch(lib.dglke_outer_stamps(stamps.ctypes.data,
                                             segs.ctypes.data), "stamps")
    ctas = int((segs > 0).sum())
    per = [stamps[i, :min(int(segs[i]), 128)].astype(np.int64)
           for i in range(ctas)]
    us = np.concatenate([np.diff(p, axis=1) for p in per]) / 1e3
    gap = np.concatenate([p[1:, 0] - p[:-1, 5] for p in per]) / 1e3
    names = ("load issued, factors staged", "slice's bulk load waited",
             "pass 1 and block sum", "partial exchange (barrier, next ids)",
             "pass 2, new slice stored", "to the next segment")
    cols = [us[:, k] for k in range(5)] + [gap]
    first = np.array([p[0, 0] for p in per], np.int64)
    last = np.array([p[-1, 5] for p in per], np.int64)
    t0 = first.min()
    print(f"K3 cluster route by phase, from the stamped build: {ctas} CTAs, "
          f"{int(segs[:ctas].min())}-{int(segs[:ctas].max())} segments each "
          f"(mean {float(segs[:ctas].mean()):.1f}); us per segment, mean "
          f"(median): " + ", ".join(
              f"{n} {float(c.mean()):.3f} ({float(np.median(c)):.3f})"
              for n, c in zip(names, cols))
          + f"; sum of means {float(sum(c.mean() for c in cols)):.3f}; "
          f"first segments start within {(first.max() - t0) / 1e3:.1f} us, "
          f"last ones end {(last.min() - t0) / 1e3:.1f}-"
          f"{(last.max() - t0) / 1e3:.1f} us after the first start")


def check_k3(label, table, ss0, ids, a, b, lr, coef, norm, plan=None):
    """K3 (along `plan`, or the wrapper's own route) against its plain
    version within K3_RTOL / K3_ATOL, two runs bit-identical, rows no id
    names unchanged.  Returns the max |diff|."""
    import torch
    from dglke_tpu_torch.ops import outer_update
    from dglke_tpu_torch.ops.embedding import EmbeddingState

    def run(kernel: bool):
        t = EmbeddingState(table.clone(), ss0.clone())
        if not kernel:
            outer_update.outer_adagrad_plain(t.emb, t.state_sum, ids, a, b,
                                             lr, coef, norm)
        elif plan is None:
            outer_update.outer_adagrad_update(t, ids, a, b, lr, coef, norm)
        else:
            outer_update.launch_outer(t, ids, a, b, lr, coef, norm, plan)
        torch.cuda.synchronize()
        return t

    got, want = run(True), run(False)
    err = 0.0
    for what, x, y in (("table", got.emb, want.emb),
                       ("state_sum", got.state_sum, want.state_sum)):
        if not torch.allclose(x, y, rtol=K3_RTOL, atol=K3_ATOL):
            fail(f"K3 {label} {what}: max |diff| "
                 f"{float((x - y).abs().max())} outside rtol {K3_RTOL} atol "
                 f"{K3_ATOL}")
        err = max(err, float((x - y).abs().max()))
    again = run(True)
    if not (torch.equal(got.emb, again.emb)
            and torch.equal(got.state_sum, again.state_sum)):
        fail(f"K3 {label}: two runs differ")
    untouched = torch.ones(table.shape[0], dtype=torch.bool,
                           device=table.device)
    untouched[ids.long()] = False
    if not bool(untouched.any()) or not (
            torch.equal(got.emb[untouched], table[untouched])
            and torch.equal(got.state_sum[untouched], ss0[untouched])):
        fail(f"K3 {label}: no untouched row, or one changed")
    print(f"K3 {label}: within rtol {K3_RTOL} / atol {K3_ATOL} of plain "
          f"(max |diff| {err:.3g}); two runs bit-identical; untouched rows "
          f"unchanged")
    return err


def phase_outer_routes():
    """K3's routes away from RESCAL's FB15k width, each held to its plain
    version: the cluster route at hidden 32 (as in the planted gates) with
    one segment longer than the staged factors hold, at a ragged 7 x 13
    width (no 16-byte path), and the tiles route at hidden 1,000."""
    import torch
    from dglke_tpu_torch.ops import outer_update
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(3)
    lr, coef, norm = (RESCAL[k] for k in ("lr", "regularization_coef",
                                          "regularization_norm"))
    for da, db, n_rows, n_ids in ((32, 32, 64, 1000), (7, 13, 64, 300),
                                  (1000, 1000, 64, 100)):
        plan = outer_update.plan_outer(da, db)
        table = torch.empty((n_rows, da * db), device=dev).uniform_(
            -0.2, 0.2, generator=gen)
        ss0 = torch.rand((n_rows,), generator=gen, device=dev)
        ids = torch.randint(0, n_rows - 4, (n_ids,), generator=gen,
                            device=dev, dtype=torch.int32)
        hot = plan.stage_occ + 8         # a segment longer than the staging
        ids[:hot] = 5
        a = torch.randn((n_ids, da), generator=gen, device=dev) * 0.3
        b = torch.randn((n_ids, db), generator=gen, device=dev) * 0.3
        check_k3(f"{plan.route} route at {da} x {db} [{n_rows} rows, {n_ids} "
                 f"ids, one id {hot + int((ids[hot:] == 5).sum())} times; "
                 f"{plan}]", table, ss0, ids, a, b, lr, coef, norm)
        del table


def phase_outer():
    """K3 against its plain version at RESCAL's FB15k shapes, two runs
    bit-identical; its time beside the plain version's, the bound, the
    tiles route, both cluster sizes that hold the row, and the stock route
    for the same update (the gradient materialized, then K2), which is also
    held to its plain version here.  K1 on the 1 MB relation rows in both
    shapes and dtypes.  Returns K3's numbers for the JSON line and K1's
    wide-row numbers."""
    import torch
    from dglke_tpu_torch.ops import outer_update, rows
    from dglke_tpu_torch.ops.embedding import EmbeddingState
    dev = torch.device("cuda")
    gen = torch.Generator(dev)
    gen.manual_seed(1)
    d = RESCAL["hidden_dim"]
    lr, coef, norm = (RESCAL[k] for k in ("lr", "regularization_coef",
                                          "regularization_norm"))
    table = torch.empty((N_REL, RESCAL_WIDTH), device=dev).uniform_(
        -0.052, 0.052, generator=gen)       # RESCAL's emb_init (24 + 2) / 500
    ss0 = torch.rand((N_REL,), generator=gen, device=dev)
    ids = torch.randint(0, N_REL, (BATCH,), generator=gen, device=dev,
                        dtype=torch.int32)
    a = torch.randn((BATCH, d), generator=gen, device=dev) * 0.1
    b = torch.randn((BATCH, d), generator=gen, device=dev) * 0.1
    n_unique = int(torch.unique(ids).numel())
    print(f"K3 shapes: relation table {N_REL} x {RESCAL_WIDTH} fp32, {BATCH} "
          f"ids ({n_unique} distinct), factors {BATCH} x {d} twice, coef "
          f"{coef}, norm {norm}")

    plan = outer_update.plan_outer(d, d)
    if plan.route != "cluster":
        fail(f"K3 at hidden {d} must take the cluster route, got {plan}")
    alt = outer_update.plan_outer(d, d, cluster=8 if plan.cluster == 16
                                  else 16)
    for p in (plan, alt):
        print(f"K3 cluster route at hidden {d}{'' if p is plan else ' (alternative)'}: "
              f"{p.cluster} CTAs x {p.slice} elements ({4 * p.slice} B), "
              f"factors of up to {p.stage_occ} occurrences staged, "
              f"{p.smem_bytes} B of shared memory per CTA; max active "
              f"clusters {outer_update.cluster_occupancy(p)}")
    k3_err = check_k3(f"outer_adagrad_update, cluster route at hidden {d} "
                      f"[{N_REL} rows, {BATCH} ids]", table, ss0, ids, a, b,
                      lr, coef, norm)
    tiles = outer_update.OuterPlan("tiles")
    for p in (alt, tiles):
        check_k3(f"{p.route} route{f' of {p.cluster} CTAs' if p.cluster else ''}"
                 f" at hidden {d}", table, ss0, ids, a, b, lr, coef, norm,
                 plan=p)

    # The stock route: the [B, 250,000] gradient materialized (outer
    # product + the regularization gradient), then K2 on 1 MB rows.
    def stock_grad():
        g = torch.einsum("bi,bj->bij", a, b).reshape(BATCH, -1)
        return g + outer_update.reg_grad(table[ids.long()], coef, norm)

    g = stock_grad()
    ek, sk = table.clone(), ss0.clone()
    rows.sparse_adagrad_rows(ek, sk, ids, g, lr)
    ep, sp = table.clone(), ss0.clone()
    rows.sparse_adagrad_plain(ep, sp, ids, g, lr)
    torch.cuda.synchronize()
    k2_err = float((ek - ep).abs().max())
    if not (torch.allclose(ek, ep, rtol=K2_RTOL, atol=K2_ATOL)
            and torch.allclose(sk, sp, rtol=K2_RTOL, atol=K2_ATOL)):
        fail(f"K2 sparse_adagrad_rows on RESCAL rows: max |diff| {k2_err} "
             f"from plain")
    k2_ms = device_ms(lambda: rows.sparse_adagrad_rows(ek, sk, ids, g, lr),
                      iters=10)
    print(f"K2 sparse_adagrad_rows on {BATCH} RESCAL rows of "
          f"{RESCAL_WIDTH}: within rtol {K2_RTOL} / atol {K2_ATOL} of plain "
          f"(max |diff| {k2_err:.3g}); device ms {k2_ms:.4f} on the "
          f"materialized gradient")
    del ek, ep, g

    state = EmbeddingState(table.clone(), ss0.clone())
    k3_ms = device_ms(lambda: outer_update.outer_adagrad_update(
        state, ids, a, b, lr, coef, norm), iters=20)
    k3_call = call_ms(lambda: outer_update.outer_adagrad_update(
        state, ids, a, b, lr, coef, norm), iters=20, warmup=2)
    # The routes in turns on the same inputs (chosen, alternative, tiles,
    # tiles, alternative, chosen).
    routes = {f"cluster of {plan.cluster} (chosen)": plan,
              f"cluster of {alt.cluster}": alt, "tiles (three launches)": tiles}
    route_ms = {k: [] for k in routes}
    for k in (*routes, *reversed(routes)):
        route_ms[k].append(device_ms(
            lambda p=routes[k]: outer_update.launch_outer(
                state, ids, a, b, lr, coef, norm, p), iters=20))
    plain_ms = device_ms(lambda: outer_update.outer_adagrad_plain(
        state.emb, state.state_sum, ids, a, b, lr, coef, norm), iters=3)
    stock_ms = device_ms(lambda: rows.sparse_adagrad_rows(
        state.emb, state.state_sum, ids, stock_grad(), lr), iters=5)
    sort_ms = device_ms(lambda: torch.sort(ids, stable=True))
    # Bytes: each distinct row read and written once, state_sum likewise,
    # ids and factors read once.  Operations: per occurrence and element,
    # g = a*b + reg', g^2 summed, g summed (5); per distinct element reg'
    # (5) and the update (3).
    k3_bytes = (2 * n_unique * RESCAL_WIDTH * 4 + 2 * n_unique * 4
                + BATCH * 4 + 2 * BATCH * d * 4)
    k3_ops = 5 * BATCH * RESCAL_WIDTH + 8 * n_unique * RESCAL_WIDTH
    k3_bound, k3_by = bound_ms(k3_bytes, k3_ops)
    print(f"K3 outer_adagrad_update, device ms: kernel {k3_ms:.4f} "
          f"({100 * k3_bound / k3_ms:.1f}% of the bound, "
          f"{k3_bytes / k3_ms / 1e9:.3f} TB/s; its id sort alone "
          f"{sort_ms:.4f}; {k3_call:.4f} per call with host overhead), plain "
          f"{plain_ms:.4f}, stock route (gradient materialized, then K2) "
          f"{stock_ms:.4f}; bound {k3_bound:.4f} ({k3_by}, "
          f"{k3_bytes / 1e9:.3f} GB, {k3_ops / 1e9:.2f} GFLOP); no single "
          f"PyTorch call computes this update")
    print("K3 routes in turns, device ms: " + ", ".join(
        f"{k} {' / '.join(f'{t:.4f}' for t in v)}"
        for k, v in route_ms.items()))
    k3_phases(state, ids, a, b, lr, coef, norm)

    # K1 on the main path's relation gather: 1,000 rows of 1 MB, both
    # shapes and dtypes exact; a width that is not a multiple of 4 or of
    # the wide chunk.
    if rows.gather_shape(RESCAL_WIDTH) != "wide":
        fail(f"K1 at width {RESCAL_WIDTH} must take the wide shape")
    bf = state.emb.to(torch.bfloat16)
    for name, tab in (("fp32", state.emb), ("bf16", bf)):
        for dim in (RESCAL_WIDTH, RESCAL_WIDTH - 3):
            want = rows.gather_rows_plain(tab, ids, dim)
            for shape in rows.GATHER_SHAPES:
                if not torch.equal(rows.launch_gather(tab, ids, dim, shape),
                                   want):
                    fail(f"K1 {shape} shape on RESCAL rows ({name}, dim "
                         f"{dim}): differs from its plain version")
            del want
        print(f"K1 gather_rows on {BATCH} RESCAL rows {name}, dims "
              f"{RESCAL_WIDTH} and {RESCAL_WIDTH - 3}: both shapes exact")
    k1_bf = device_ms(lambda: rows.gather_rows(bf, ids), iters=20)
    del bf
    gather_fns = {
        "wide": lambda: rows.launch_gather(state.emb, ids, RESCAL_WIDTH,
                                           "wide"),
        "warp (one per row)": lambda: rows.launch_gather(
            state.emb, ids, RESCAL_WIDTH, "warp"),
        "index_select": lambda: torch.index_select(state.emb, 0, ids)}
    # Three rounds in turns, each on the profiler's device clock and on
    # CUDA events around back-to-back calls.
    gather_ms = {k: [] for k in gather_fns}
    gather_ev = {k: [] for k in gather_fns}
    for r in range(3):
        for k in (gather_fns if r % 2 == 0 else reversed(gather_fns)):
            gather_ms[k].append(device_ms(gather_fns[k], iters=20))
            gather_ev[k].append(call_ms(gather_fns[k], iters=20, warmup=3))
    k1_ms, _, k1_lib = (sum(v) / len(v) for v in gather_ms.values())
    k1_ev, _, k1_lib_ev = (sum(v) / len(v) for v in gather_ev.values())
    k1_bytes = BATCH * 4 + (n_unique + BATCH) * RESCAL_WIDTH * 4
    k1_bound, k1_by = bound_ms(k1_bytes, 0)
    print(f"K1 gather_rows on {BATCH} RESCAL rows of {RESCAL_WIDTH} fp32, "
          f"three rounds in turns, device ms (CUDA events ms per call): "
          + ", ".join(f"{k} {' / '.join(f'{t:.4f}' for t in v)} ("
                      f"{' / '.join(f'{t:.4f}' for t in gather_ev[k])})"
                      for k, v in gather_ms.items())
          + f"; bound {k1_bound:.4f} ({k1_by}, {k1_bytes / 1e9:.3f} GB); "
          f"wide {100 * k1_bound / k1_ms:.1f}% of it, "
          f"{k1_bytes / k1_ms / 1e9:.3f} TB/s; wide on the bf16 table "
          f"{k1_bf:.4f}")
    print(f"K1 wide against index_select on RESCAL rows, mean of three: "
          f"device {k1_ms:.4f} vs {k1_lib:.4f} ms, CUDA events {k1_ev:.4f} vs "
          f"{k1_lib_ev:.4f} ms: {'not slower' if k1_ms <= k1_lib else 'SLOWER'}")
    del state, table
    torch.cuda.empty_cache()
    k3 = {"name": "outer_adagrad_update", "route": "cuda",
          "source": "dglke_tpu_torch/ops/csrc/outer_update.cu",
          "replaces": "dglke_tpu/ops/pallas/outer_update.py:118",
          "launches": None, "max_abs_err": k3_err, "ms": k3_ms,
          "plain_ms": plain_ms, "bound_ms": k3_bound, "bound_by": k3_by,
          "library_ms": None}
    k1_wide = {"wide_ms": k1_ms, "wide_library_ms": k1_lib,
               "wide_bound_ms": k1_bound}
    return k3, k1_wide


# ---------------------------------------------------------------------------
# Phases 3 and 4: the main paths


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


def _recipe_flags(recipe: dict):
    flags = ["--model_name", recipe["model_name"],
             "--hidden_dim", str(recipe["hidden_dim"]),
             "--gamma", str(recipe["gamma"]), "--lr", str(recipe["lr"]),
             "--batch_size", str(recipe["batch_size"]),
             "--neg_sample_size", str(recipe["neg_sample_size"]),
             "-rc", str(recipe["regularization_coef"])]
    return flags + (["-adv"] if recipe["neg_adversarial_sampling"] else [])


def phase_main_path(recipe: dict, batch_size_eval: int,
                    steps: int = MAIN_STEPS):
    """dglke_tpu_torch-train on the card with the recipe's flags on the
    FB15k-shaped data; returns the launch counts of that run only."""
    from dglke_tpu_torch.cli import train as train_cli
    from dglke_tpu_torch.ops import rows
    name = recipe["model_name"]
    data = os.path.join(WORK, "data")
    if not os.path.isdir(data):
        _write_fb15k_shaped(data, n_train=300_000)
    argv = ["--dataset", "fb15k_shaped", "--data_path", data, "--format",
            "udd_hrt", "--data_files", "entities.tsv", "relations.tsv",
            "train.tsv", "valid.tsv", "test.tsv", *_recipe_flags(recipe),
            "--max_step", str(steps), "--log_interval", str(steps // 4),
            "--batch_size_eval", str(batch_size_eval), "--test",
            "--save_path", os.path.join(WORK, "ckpts")]
    print(f"{name} main path: dglke_tpu_torch-train " + " ".join(argv))
    out = io.StringIO()
    rows.reset_launches()
    with contextlib.redirect_stdout(out):
        rc = train_cli.main(argv)
    counts = dict(rows.launches)
    text = out.getvalue()
    print(text.rstrip())
    if rc != 0:
        fail(f"{name} main path: train CLI returned {rc}")
    losses = _floats(r"average loss: (\S+)", text)
    mrr = _floats(r"\[0\]Test average MRR: (\S+)", text)
    train_s = _floats(r"training takes (\S+) seconds", text)
    eval_s = _floats(r"\[0\]Test takes (\S+) seconds", text)
    if not losses or not all(math.isfinite(x) for x in losses):
        fail(f"{name} main path: loss not finite: {losses}")
    if len(mrr) != 1 or not 0.0 < mrr[0] <= 1.0:
        fail(f"{name} main path: test MRR {mrr} outside (0, 1]")
    want = EXPECTED_LAUNCHES[name]
    if any(counts[k] != v for k, v in want.items()):
        fail(f"{name} main path: launches {counts}, expected {want}")
    print(f"{name} main path: {steps} steps, "
          f"{steps * BATCH / train_s[0]:.1f} triples/s (host clock over the "
          f"whole loop, first step included), test eval {eval_s[0]:.3f} s, "
          f"MRR {mrr[0]:.4f}, last loss {losses[-1]:.4f}; launches {counts}")
    return counts


def phase_step_parity(recipe: dict):
    """One step in each corruption direction on the card and on the CPU
    (the plain versions), from identical tables and ids, at the recipe's
    full width: every table, Adagrad state and the loss within rtol 1e-4 /
    atol 1e-5 (cuBLAS and the CPU sum in other orders; the first Adagrad
    step scales each gradient row to unit RMS, so it carries those
    differences into the tables at full size)."""
    import torch
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.utils.convert import state_from_numpy, state_to_numpy
    name = recipe["model_name"]
    cfg = KGEConfig(**recipe)
    rng = np.random.default_rng(1)
    gpu_model = KEModel(cfg, N_ENT, N_REL, device="cuda")
    cpu_model = KEModel(cfg, N_ENT, N_REL, device="cpu")
    arrays = state_to_numpy(gpu_model.init_state())
    state = state_from_numpy(arrays, device="cpu")
    gpu_state = state_from_numpy(arrays, device="cuda")
    del arrays
    cpu_s = 0.0
    for neg_head in (True, False):
        ids = [rng.integers(0, n, size).astype(np.int32) for n, size in
               ((N_ENT, BATCH), (N_REL, BATCH), (N_ENT, BATCH),
                (N_ENT, N_ENT_IDS - 2 * BATCH))]
        t0 = time.time()
        _, clog = cpu_model.train_step(
            state, *(torch.from_numpy(x) for x in ids), None,
            neg_head=neg_head)
        cpu_s += time.time() - t0
        _, glog = gpu_model.train_step(
            gpu_state, *(torch.from_numpy(x).cuda() for x in ids), None,
            neg_head=neg_head)
        pairs = [("loss", glog["loss"], clog["loss"])]
        for table in ("entity", "relation"):
            g, c = getattr(gpu_state, table), getattr(state, table)
            pairs += [(f"{table} emb", g.emb, c.emb),
                      (f"{table} state_sum", g.state_sum, c.state_sum)]
        for what, a, b in pairs:
            a = a.cpu()
            if not torch.allclose(a, b, rtol=1e-4, atol=1e-5):
                fail(f"{name} step parity ({'head' if neg_head else 'tail'})"
                     f": {what} on the card differs from the CPU by "
                     f"{float((a - b).abs().max())}")
    print(f"{name} step parity: two full-width steps (batch {BATCH}) on the "
          f"card match the CPU's plain path within rtol 1e-4 / atol 1e-5 "
          f"(CPU side {cpu_s:.1f} s)")


def phase_step_profile(recipe: dict, steps: int):
    """Where a step's time goes: the host clock over `steps`
    DevicePipeline steps, then torch.profiler over the same number for the
    device's busy share and the kernels by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    from dglke_tpu_torch.models.ke_model import KEModel
    from dglke_tpu_torch.trainer import DevicePipeline
    name = recipe["model_name"]
    cfg = KGEConfig(**recipe)
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
    print(f"{name} step profile: {step_ms:.4f} ms per step on the host "
          f"clock ({BATCH * 1e3 / step_ms:.1f} triples/s); device busy "
          f"{busy:.4f} ms per step ({100 * busy / step_ms:.1f}%, idle "
          f"{100 - 100 * busy / step_ms:.1f}%); "
          f"{sum(e.count for e in kern) / steps:.1f} kernels per step")
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  {e.self_device_time_total / 1e3 / steps:.4f} ms/step "
              f"x{e.count / steps:.1f}  {e.key[:90]}")


# ---------------------------------------------------------------------------
# Phase 5

# tests/test_planted_quality.py:27-46: (model, structure, overrides)
PLANTED_BASE = dict(hidden_dim=32, gamma=6.0, lr=0.25, batch_size=128,
                    neg_sample_size=32, max_step=1500, batch_size_eval=16,
                    log_interval=10**9, neg_adversarial_sampling=True,
                    regularization_coef=1e-9, seed=7, dataset="synthetic")
PLANTED = [
    ("TransE_l2", "line", dict(gamma=4.0, max_step=2000)),
    ("TransE_l1", "line", dict(gamma=8.0)),
    ("TransR", "line", dict(hidden_dim=16, lr=0.15)),
    ("RotatE", "line", dict(double_ent=True, lr=0.1)),
    ("DistMult", "cliques", dict(neg_adversarial_sampling=False,
                                 regularization_coef=2e-6, lr=0.15)),
    ("ComplEx", "cycle", dict(neg_adversarial_sampling=False,
                              regularization_coef=2e-6, lr=0.15)),
    ("SimplE", "cycle", dict(neg_adversarial_sampling=False,
                             regularization_coef=2e-6, lr=0.15)),
    ("RESCAL", "cycle", dict(hidden_dim=16, lr=0.1,
                             neg_adversarial_sampling=False)),
]


def phase_planted():
    from dglke_tpu_torch.config import KGEConfig
    from dglke_tpu_torch.data.dataset import planted_dataset
    from dglke_tpu_torch.trainer import evaluate, train
    quiet = lambda *a: None  # noqa: E731
    for name, structure, overrides in PLANTED:
        ds = planted_dataset(structure,
                             n_clusters=8 if structure == "cycle" else 10)
        cfg = KGEConfig(**{**PLANTED_BASE, "model_name": name, **overrides})
        t0 = time.time()
        model, state, _ = train(cfg, ds, log=quiet)
        m = evaluate(cfg, ds, model, state, "test", log=quiet)
        if m["MRR"] < 0.85 or m["HITS@10"] < 0.99:
            fail(f"planted {name} gate failed on the card: {m}")
        print(f"planted {name} ({structure}) gate: MRR {m['MRR']:.4f}, "
              f"HITS@10 {m['HITS@10']:.4f} (gate MRR >= 0.85, HITS@10 >= "
              f"0.99), {cfg.max_step} steps + eval in "
              f"{time.time() - t0:.1f} s")


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
        phase_gather_shapes()
        k3, k1_wide = phase_outer()
        kernels[0].update(k1_wide)
        kernels.append(k3)
        phase_outer_routes()
        paths = {"TransE_l2": phase_main_path(TRANSE, batch_size_eval=500)}
        phase_step_parity(TRANSE)
        phase_step_profile(TRANSE, steps=50)
        paths["RESCAL"] = phase_main_path(RESCAL,
                                          batch_size_eval=RESCAL_EVAL_BATCH)
        phase_step_parity(RESCAL)
        phase_step_profile(RESCAL, steps=20)
        phase_planted()
    finally:
        shutil.rmtree(WORK, ignore_errors=True)
    # launches: the sum over the two main-path runs, each read around its
    # own run only
    for k in kernels:
        k["launches"] = sum(c[k["name"]] for c in paths.values())
        if k["launches"] <= 0:
            fail(f"kernel {k['name']} was launched on no main path")
    print("kernels: " + ", ".join(
        f"{k['name']} ({k['route']}, launches "
        + " + ".join(f"{c[k['name']]} {p}" for p, c in paths.items()) + ")"
        for k in kernels))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
