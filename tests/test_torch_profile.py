"""--profile, the host-fed route's phase timers and Prefetcher, and the
small pieces of the last slice, against the JAX package where it has them:

  * ``--profile DIR`` writes a torch.profiler trace (Chrome/Perfetto JSON)
    of the JAX package's window, the steps [2s, 4s) of s-step groups, one
    ``step N`` span a step, and logs the JAX package's
    ``[proc 0]profiler trace written``; the tables are bit-equal to a run
    without it; host-table training (--mix_cpu_gpu) traces the same way;
  * the host-fed route logs ``[proc 0]sample: X, update: Y`` after each
    log flush, in the JAX package's format;
  * trainer.Prefetcher hands over its stream's items in order, ends with a
    finite stream and raises an error of the stream in the consumer; the
    host feed's batches are the TrainSampler's, in order;
  * planted_ring_big / planted_line_big draw the JAX package's triples,
    bit for bit; utils.io.load_raw_emb reads what the JAX package's does.
"""

import json
import os
import re
import threading

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data import dataset as jds
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.trainer import train as jax_train
from dglke_tpu.utils.io import load_raw_emb as jax_load_raw_emb
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data import dataset as pds
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.data.sampler import TrainSampler
from dglke_tpu_torch.models.fed_step import unpack_batch
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import HostFeed, Prefetcher, train
from dglke_tpu_torch.utils.io import load_raw_emb

torch.set_num_threads(2)

N_ENT, N_REL = 60, 4


def _cfg(**over):
    kw = dict(model_name="TransE_l2", hidden_dim=8, gamma=4.0, lr=0.25,
              batch_size=16, neg_sample_size=4, max_step=40, log_interval=10,
              neg_adversarial_sampling=True, regularization_coef=1e-3,
              seed=3)
    kw.update(over)
    return KGEConfig(**kw)


def _run(ds, profile_dir=None, **over):
    logs = []
    _, state, _ = train(_cfg(**over), ds, log=logs.append, device="cpu",
                        profile_dir=profile_dir)
    return state, logs


def _spans(path):
    with open(path) as f:
        trace = json.load(f)
    return sorted(int(m.group(1)) for e in trace["traceEvents"]
                  if e.get("cat") == "user_annotation"
                  and (m := re.fullmatch(r"step (\d+)", str(e.get("name")))))


@pytest.mark.parametrize("n_train,route", [(400, "device-resident"),
                                           (20, "host-fed")])
def test_profile_traces_the_window_and_leaves_the_tables(tmp_path, n_train,
                                                         route):
    """s = 10 here (the 16-step default cut to divide the log interval),
    so the trace holds steps 20-39; the run's tables are the run without
    --profile's, bit for bit."""
    ds = synthetic_dataset(N_ENT, N_REL, n_train=n_train, n_valid=5,
                           n_test=5, seed=1)
    traced, logs = _run(ds, str(tmp_path / "prof"))
    plain, _ = _run(ds)
    assert any(route in x for x in logs), logs
    assert logs.count("[proc 0]profiler trace written") == 1
    assert _spans(tmp_path / "prof" / "trace_rank0.json") == list(
        range(20, 40))
    for name in ("entity", "relation"):
        for part in ("emb", "state_sum"):
            assert torch.equal(getattr(getattr(traced, name), part),
                               getattr(getattr(plain, name), part))


def test_profile_stops_at_the_end_of_a_short_run(tmp_path):
    """A run that ends inside the window writes what it traced."""
    ds = synthetic_dataset(N_ENT, N_REL, n_train=400, seed=1)
    _, logs = _run(ds, str(tmp_path), max_step=30)
    assert logs.count("[proc 0]profiler trace written") == 1
    assert _spans(tmp_path / "trace_rank0.json") == list(range(20, 30))


def test_profile_through_the_cli_and_host_tables(tmp_path, capsys):
    """dglke_tpu_torch-train --profile DIR, on device tables and with
    --mix_cpu_gpu (whose host loop steps one at a time over the same
    window)."""
    from dglke_tpu_torch.cli import train as cli
    d = tmp_path / "data"
    d.mkdir()
    ds = synthetic_dataset(N_ENT, N_REL, n_train=400, n_valid=5, n_test=5,
                           seed=2)
    (d / "entities.tsv").write_text(
        "".join(f"{i}\te{i}\n" for i in range(N_ENT)))
    (d / "relations.tsv").write_text(
        "".join(f"{i}\tr{i}\n" for i in range(N_REL)))
    for split in ("train", "valid", "test"):
        np.savetxt(d / f"{split}.tsv", np.stack(getattr(ds, split), axis=1),
                   fmt="%d", delimiter="\t")
    for mode in ((), ("--mix_cpu_gpu",)):
        out = tmp_path / ("host" if mode else "dev")
        assert cli.main([
            "--device", "cpu", "--dataset", "kg", "--data_path", str(d),
            "--format", "udd_hrt", "--data_files", "entities.tsv",
            "relations.tsv", "train.tsv", "valid.tsv", "test.tsv",
            "--model_name", "TransE_l2", "--hidden_dim", "8",
            "--batch_size", "16", "--neg_sample_size", "4", "--max_step",
            "40", "--log_interval", "10", "--no_save_emb", "--profile",
            str(out / "trace"), "--save_path", str(out / "ck"), *mode]) == 0
        assert "[proc 0]profiler trace written" in capsys.readouterr().out
        assert _spans(out / "trace" / "trace_rank0.json") == list(
            range(20, 40))


_TIMERS = re.compile(r"\[proc 0\]sample: \d+\.\d{3}, update: \d+\.\d{3}")


def test_host_fed_route_logs_the_phase_timers():
    """After each log flush on the host-fed route, as the JAX package's
    host-fed route logs it (trainer.py:341-344); the device pipeline logs
    no such line, in either package."""
    small = dict(n_entities=N_ENT, n_relations=N_REL, n_train=20, n_valid=5,
                 n_test=5, seed=1)
    _, logs = _run(synthetic_dataset(**small))
    timers = [i for i, x in enumerate(logs) if _TIMERS.fullmatch(x)]
    flushes = [i for i, x in enumerate(logs) if "steps take" in x]
    assert len(timers) == 4 and timers == [i + 1 for i in flushes], logs
    jlogs = []
    jax_train(JaxConfig(**{k: getattr(_cfg(), k) for k in (
        "model_name", "hidden_dim", "gamma", "lr", "batch_size",
        "neg_sample_size", "max_step", "log_interval",
        "neg_adversarial_sampling", "regularization_coef", "seed")}),
        jax_synthetic(**small), log=jlogs.append)
    assert any(_TIMERS.fullmatch(x) for x in jlogs), jlogs
    _, dev = _run(synthetic_dataset(N_ENT, N_REL, n_train=400, seed=1))
    assert not any(_TIMERS.fullmatch(x) for x in dev)


# ---------------------------------------------------------------------------
# Prefetcher


def test_prefetcher_keeps_the_order_and_ends():
    staged = []

    def stage(x):
        staged.append(threading.current_thread().name)
        return x * 10

    pre = Prefetcher(range(25), stage)
    assert list(pre) == [x * 10 for x in range(25)]
    assert threading.current_thread().name not in staged
    pre.close()
    assert not pre._thread.is_alive()


def test_prefetcher_raises_the_feeders_error_in_the_consumer():
    def feeder():
        yield from range(3)
        raise ValueError("feeder broke")

    pre = Prefetcher(feeder(), lambda x: x)
    assert [next(pre) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(ValueError, match="feeder broke"):
        next(pre)
    pre.close()


def test_prefetcher_close_stops_an_endless_feeder():
    pre = Prefetcher(iter(int, 1), lambda x: x)    # endless zeros
    assert next(pre) == 0
    pre.close()
    assert not pre._thread.is_alive()


@pytest.mark.parametrize("n_train", [5, 40])
def test_host_feed_hands_over_the_samplers_batches_in_order(n_train):
    """With the Prefetcher between them, the host feed's batches are the
    TrainSampler's drawn inline, in the same order, with edge weights."""
    ds = synthetic_dataset(N_ENT, N_REL, n_train=n_train, seed=4)
    h, r, t = ds.train
    ds.train = (h, r, t, np.linspace(0.5, 2.0, n_train).astype(np.float32))
    model = KEModel(_cfg(), N_ENT, N_REL, device="cpu")
    feed = HostFeed(model, ds, 16, 4, seed=9)
    inline = TrainSampler(ds, 16, 4, seed=9)
    for _ in range(12):
        want = next(inline)
        packed, impts, neg_head, b = feed.take(1)[0]
        for x, k in zip(unpack_batch(packed, b), ("h", "r", "t", "neg")):
            assert x.dtype == torch.int32
            np.testing.assert_array_equal(x.numpy(), want[k])
        np.testing.assert_array_equal(impts.numpy(), want["impts"])
        assert neg_head == want["neg_head"]
    feed.close()


# ---------------------------------------------------------------------------
# planted_*_big, load_raw_emb


@pytest.mark.parametrize("kw", [
    dict(n_clusters=40, per=4),
    dict(n_clusters=60, per=3, n_relations=3, seed=5, n_test=50),
    dict(n_clusters=60, per=2, n_relations=2, line_len=12, seed=1),
], ids=["one_line", "three_relations", "lines_of_12"])
def test_planted_line_big_matches_jax(kw):
    got, want = pds.planted_line_big(**kw), jds.planted_line_big(**kw)
    _same_dataset(got, want)


@pytest.mark.parametrize("kw", [
    dict(n_clusters=40, ring_len=8),
    dict(n_clusters=60, ring_len=6, per=3, n_relations=4, seed=2, n_test=30),
], ids=["one_relation", "four_relations"])
def test_planted_ring_big_matches_jax(kw):
    got, want = pds.planted_ring_big(**kw), jds.planted_ring_big(**kw)
    _same_dataset(got, want)


def _same_dataset(got, want):
    assert (got.name, got.n_entities, got.n_relations) == (
        want.name, want.n_entities, want.n_relations)
    for split in ("train", "test"):
        for g, w in zip(getattr(got, split), getattr(want, split)):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_planted_big_refuses_what_the_jax_package_asserts():
    with pytest.raises(ValueError, match="ring_len"):
        pds.planted_ring_big(n_clusters=10, ring_len=4)
    with pytest.raises(ValueError, match="line_len"):
        pds.planted_line_big(n_clusters=10, n_relations=3, line_len=3)


def test_load_raw_emb_reads_what_the_jax_package_reads(tmp_path):
    arr = np.random.default_rng(0).standard_normal((7, 5)).astype(
        np.float32)
    np.save(os.path.join(tmp_path, "kg_TransE_l2_entity.npy"), arr)
    got = load_raw_emb(str(tmp_path), "kg_TransE_l2", "entity")
    want = jax_load_raw_emb(str(tmp_path), "kg_TransE_l2", "entity")
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, arr)
