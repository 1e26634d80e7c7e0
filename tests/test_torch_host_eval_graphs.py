"""Host mode's eval calls (dglke_tpu_torch/host_table.py over
models/eval_step.py: host_pos_side, host_block_counts and the sampled
group call) against the JAX package's evaluate_host (_host_pos_side_fn,
_host_block_counts_fn, _host_sampled_ranks_fn) on the same numpy tables:
integer ranks identical.

The block width and the query chunk are monkeypatched small in both
packages, so that the 200 entities stream in four blocks of 64 (the tail
block starting early, at row 136, over rows the third block counted) and
each direction's 100 queries in four chunks of 32, the last padded.  Raw
(unfiltered) full-entity ranks may differ by one at the true entity's own
tie, and raw sampled ranks by the sampled copies of the true entity, the
recorded deliberate difference (ROADMAP section C).  On the CPU every
call runs eagerly; the stand-in card cases run the graph route's memo,
with a replay that re-runs the captured call: a block offset captured as
a number, not read from the 0-d tensors, would rank every later block at
the capture's place.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

import dglke_tpu.host_table as jht
from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.models import ke_model as jke
import dglke_tpu_torch.host_table as pht
from dglke_tpu_torch import trainer as ptrainer
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
from dglke_tpu_torch.models import eval_step
from dglke_tpu_torch.models.eval_step import EvalCalls
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.ops import rows

torch.set_num_threads(2)

N_ENT, N_REL, DIM, N_TEST = 200, 5, 8, 100
BLOCK = 64     # blocks at rows 0, 64, 128 and 136 (the tail)
Q_MIN = 32     # 100 queries a direction: chunks of 32, padded to 128
FAMILIES = {"TransE_l2": {}, "RotatE": dict(double_ent=True),
            "DistMult": {}, "TransR": {}}
QUIET = lambda *a: None  # noqa: E731


@pytest.fixture(scope="module")
def datasets():
    kw = dict(n_entities=N_ENT, n_relations=N_REL, n_train=2000,
              n_valid=60, n_test=N_TEST, seed=3)
    return synthetic_dataset(**kw), jax_synthetic(**kw)


def _configs(name, **over):
    kw = dict(model_name=name, hidden_dim=DIM, gamma=6.0,
              batch_size_eval=16, mix_cpu_gpu=True, seed=7,
              **FAMILIES[name])
    kw.update(over)
    return KGEConfig(**kw), JaxConfig(**kw)


def _models(name, **over):
    pcfg, jcfg = _configs(name, **over)
    return (pcfg, KEModel(pcfg, N_ENT, N_REL, device="cpu"), jcfg,
            jke.KEModel(jcfg, N_ENT, N_REL))


def _states(model, seed=0):
    """(the port's HostState, the JAX package's) over copies of the same
    numpy tables, uniform in (-1, 1) from ``seed``."""
    rng = np.random.default_rng(seed)
    shapes = [(N_ENT, model.entity_dim), (N_REL, model.relation_dim)]
    if model.is_transr:
        shapes.append((N_REL, model.proj_dim))
    arrays = [rng.uniform(-1, 1, s).astype(np.float32) for s in shapes]
    arrays += [None] * (3 - len(arrays))

    def port(a):
        return None if a is None else pht.HostEmbedding(
            torch.from_numpy(a.copy()), torch.zeros(len(a)))

    def jax_(a):
        return None if a is None else jht.HostEmbedding(
            a.copy(), np.zeros(len(a), np.float32))

    return (pht.HostState(*map(port, arrays), 0),
            jht.HostState(*map(jax_, arrays), 0))


@pytest.fixture
def small_blocks(monkeypatch):
    """Four blocks of BLOCK rows and chunks of Q_MIN queries, in both
    packages."""
    for module in (pht, jht):
        monkeypatch.setattr(module, "_Q_CAP_BYTES", 1)
        monkeypatch.setattr(module, "_Q_MIN_CHUNK", Q_MIN)
    for cls in (KEModel, jke.KEModel):
        monkeypatch.setattr(cls, "_eval_block_size", lambda self, b: BLOCK)


def _ranks_of(monkeypatch, module, name):
    """The rank arrays handed to ``module.name`` (the metrics function an
    eval ends in), kept."""
    seen = []
    real = getattr(module, name)

    def keep(ranks, *a, **k):
        seen.append(np.asarray(ranks, np.int64).copy())
        return real(ranks, *a, **k)

    monkeypatch.setattr(module, name, keep)
    return seen


def _block_calls(calls) -> dict:
    """Calls of each host_block key by its staging buffer."""
    return {k[-3]: n for k, n in calls.keys.items()
            if k[0] == "host_block"}


@pytest.mark.usefixtures("small_blocks")
@pytest.mark.parametrize("filtered", [True, False], ids=["filtered", "raw"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_block_streamed_eval_matches_jax(datasets, monkeypatch, name,
                                         filtered):
    pcfg, pm, jcfg, jm = _models(name, no_eval_filter=not filtered)
    pstate, jstate = _states(pm)
    got = _ranks_of(monkeypatch, ptrainer, "combine_rank_metrics")
    want = _ranks_of(monkeypatch, jke, "metrics_from_ranks")
    lines = []
    pht.evaluate_host(pcfg, datasets[0], pm, pstate, "test",
                      log=lines.append)
    jht.evaluate_host(jcfg, datasets[1], jm, jstate, "test", log=QUIET)
    (got,), (want,) = got, want
    assert got.shape == want.shape == (2 * N_TEST,)
    if filtered:
        np.testing.assert_array_equal(got, want)
    else:
        # the true entity's own tie: one rank step at most
        assert np.abs(got - want).max() <= 1
    # four blocks, two a staging buffer; one pos/side call a direction;
    # on the CPU no graph line
    calls = pm.eval_calls
    assert _block_calls(calls) == {0: 2, 1: 2}
    assert sorted(k[:3] for k in calls.keys if k[0] == "host_pos_side") == [
        ("host_pos_side", "Test", False), ("host_pos_side", "Test", True)]
    assert [d["counts"].shape for d in next(iter(
        calls.blocks.values())).dirs] == [(128,), (128,)]
    assert not any("CUDA graphs" in x for x in lines)


def _dirs(model, state, rng, n=40, width=6):
    """Two directions' HostBlocks dicts on random queries and filter lists
    (every id a real entity, about half of them masked in)."""
    dirs = []
    for neg_head in (True, False):
        ids = torch.from_numpy(np.concatenate([
            rng.integers(0, N_ENT, 2 * n),
            rng.integers(0, N_REL, n)]).astype(np.int32))
        pos, side, rel, proj = pht.host_pos_side(model, state, ids,
                                                 neg_head=neg_head)
        dirs.append(dict(
            neg_head=neg_head, pos=pos, side=side, rel=rel, proj=proj,
            fid=torch.from_numpy(rng.integers(0, N_ENT, (n, width)).astype(
                np.int32)),
            fm=torch.from_numpy((rng.random((n, width)) < 0.5).astype(
                np.uint8)),
            counts=torch.zeros(n, dtype=torch.int64)))
    return dirs


@pytest.mark.parametrize("name", list(FAMILIES))
def test_block_counts_with_tensor_offsets_are_the_int_offsets(name):
    """host_block_counts with the block's place as 0-d int64 tensors (as a
    CUDA graph reads it) counts bit for bit what it counts with ints, for
    every block of the stream, the overlapping tail included."""
    _, pm, _, _ = _models(name)
    pstate, _ = _states(pm)
    rng = np.random.default_rng(1)
    by_int = _dirs(pm, pstate, rng)
    by_tensor = [dict(d, counts=d["counts"].clone()) for d in by_int]
    emb = pstate.entity.emb
    for start in range(0, N_ENT, BLOCK):
        cs = min(start, N_ENT - BLOCK)
        cand = emb[cs:cs + BLOCK]
        pht.host_block_counts(pm, cand, cs, start, by_int, 16)
        pht.host_block_counts(pm, cand, torch.tensor(cs),
                              torch.tensor(start), by_tensor, 16)
        for a, b in zip(by_int, by_tensor):
            assert torch.equal(a["counts"], b["counts"])
    assert all(d["counts"].abs().sum() > 0 for d in by_int)


def _sampled_ties(cfg, ds, state):
    """Per ranked row, in the eval's order: the candidates that are the
    true entity itself (sampled, or with neg_deg_sample another real row's
    own entity of the batch), kept ones only."""
    ent = np.arange(N_ENT)
    out = []
    for mode in ("head", "tail"):
        for ba in EvalSampler(ds, "test", cfg.batch_size_eval, mode,
                              FilterIndex(ds) if cfg.eval_filter else None,
                              seed=cfg.seed,
                              neg_sample_size=cfg.neg_sample_size_eval,
                              neg_deg_sample=cfg.neg_deg_sample_eval):
            true = ent[ba["h"] if ba["neg_head"] else ba["t"]]
            same = ba["neg"][None] == true[:, None]
            if "neg_keep" in ba:
                same &= ba["neg_keep"] > 0
            n = same.sum(1)
            if ba["neg_deg_sample"]:
                own = true[None, :ba["n_valid"]] == true[:, None]
                n = n + own.sum(1) - 1
            out.append(n[:ba["n_valid"]])
    return np.concatenate(out)


def _as_on_a_card(mp):
    """Batch the port's eval as on a card (each tail group padded to the
    call shape), every call still run eagerly."""
    def eager(self, state, static, fn, args):
        self.keys[self._key(state, static, args)] += 1
        return fn(*args)

    mp.setattr(EvalCalls, "on_graphs", lambda self, state: True)
    mp.setattr(EvalCalls, "_call", eager)


SAMPLED = {"filtered": dict(neg_sample_size_eval=50),
           "raw": dict(neg_sample_size_eval=50, no_eval_filter=True),
           "neg_deg_sample": dict(neg_sample_size_eval=50,
                                  no_eval_filter=True,
                                  neg_deg_sample_eval=True)}


@pytest.mark.parametrize("case", list(SAMPLED))
def test_sampled_host_eval_padded_as_on_a_card(datasets, monkeypatch,
                                               case):
    """--neg_sample_size_eval on host tables at batch 3: 34 batches a
    mode, the last with one real row, ranked in groups of 32 (the tail
    group of 2 padded to 32 where the calls run as CUDA graphs): the
    padded ranks are the unpadded ones exactly, and the JAX package's
    _evaluate_host_sampled's (a batch a call) but for the self-ties of
    raw ranking."""
    pcfg, pm, jcfg, jm = _models("TransE_l2", batch_size_eval=3,
                                 **SAMPLED[case])
    pstate, jstate = _states(pm)
    got = _ranks_of(monkeypatch, ptrainer, "combine_rank_metrics")
    want = _ranks_of(monkeypatch, jke, "metrics_from_ranks")
    pht.evaluate_host(pcfg, datasets[0], pm, pstate, "test", log=QUIET)
    with monkeypatch.context() as mp:
        _as_on_a_card(mp)
        padded = KEModel(pcfg, N_ENT, N_REL, device="cpu")
        lines = []
        pht.evaluate_host(pcfg, datasets[0], padded, pstate, "test",
                          log=lines.append)
    jht.evaluate_host(jcfg, datasets[1], jm, jstate, "test", log=QUIET)
    unpadded, padded_ranks = got
    (want,) = want
    assert padded_ranks.shape == (2 * N_TEST,)
    np.testing.assert_array_equal(padded_ranks, unpadded)
    # one call shape a mode on the card's batching: 2 groups of 32 each
    assert sorted(padded.eval_calls.keys.values()) == [2, 2]
    assert any(x.startswith("[0]Test eval CUDA graphs:") for x in lines)
    ties = _sampled_ties(pcfg, datasets[0], pstate)
    diff = np.abs(unpadded - want)
    assert np.all(diff <= ties) and np.all(diff[ties == 0] == 0)
    if case == "filtered":
        np.testing.assert_array_equal(unpadded, want)


@pytest.mark.usefixtures("small_blocks")
@pytest.mark.parametrize("kind", ["full", "sampled"])
def test_evals_of_one_split_share_keys_valid_and_test_do_not(datasets,
                                                             kind):
    """Two Test evals of one split make the same calls under the same memo
    keys (a --valid run reuses its graphs every interval); the Valid eval
    of another split keeps keys of its own."""
    over = {} if kind == "full" else dict(neg_sample_size_eval=50)
    pcfg, pm, _, _ = _models("TransE_l2", **over)
    pstate, _ = _states(pm)
    calls = pm.eval_calls
    pht.evaluate_host(pcfg, datasets[0], pm, pstate, "test", log=QUIET)
    first = dict(calls.keys)
    pht.evaluate_host(pcfg, datasets[0], pm, pstate, "test", log=QUIET)
    assert dict(calls.keys) == {k: 2 * n for k, n in first.items()}
    pht.evaluate_host(pcfg, datasets[0], pm, pstate, "valid",
                      phase="Valid", log=QUIET)
    valid = set(calls.keys) - set(first)
    assert len(valid) == len(first)
    assert {k[1] for k in valid} == {"Valid"}
    assert {k[1] for k in first} == {"Test"}
    if kind == "full":
        assert sorted(k[0] for k in first) == [
            "host_block", "host_block", "host_pos_side", "host_pos_side"]
        assert len(calls.blocks) == 2
    else:
        assert {k[0] for k in first} == {"sampled"}
        assert not calls.blocks


# ---------------------------------------------------------------------------
# The graph route on a stand-in for the card


class _FakeGraph:
    """A replay that re-runs the captured call into the captured output
    (a real replay runs no Python and counts no launch)."""

    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        before = dict(rows.launches)
        out = self.fn()
        for x, y in zip(*(o if isinstance(o, tuple) else (o,)
                          for o in (self.out, out))):
            if x is not None:
                x.copy_(y)
        rows.launches.update(before)

    def pool(self):
        return "pool"


def _stand_in_card(monkeypatch):
    """EvalCalls on a stand-in card: each key's first call eagerly, a
    capture that changes nothing (it runs the call and puts every block
    count back), replays of _FakeGraph."""
    monkeypatch.setattr(EvalCalls, "on_graphs", lambda self, state: True)
    monkeypatch.setattr(eval_step, "run_on_capture_stream",
                        lambda device, fn: ("stream", fn()))

    def capture(fn, stream, pool=None, generators=()):
        assert stream == "stream"
        counts = [d["counts"] for calls in live for hb in calls.blocks
                  .values() for d in hb.dirs]
        saved = [c.clone() for c in counts]
        before = dict(rows.launches)
        out = fn()
        for c, s in zip(counts, saved):
            c.copy_(s)
        return _FakeGraph(fn, out), out, rows.take_launches(before)

    live = []
    monkeypatch.setattr(eval_step, "capture", capture)
    return live


@pytest.mark.usefixtures("small_blocks")
@pytest.mark.parametrize("name,over", [
    ("TransE_l2", {}), ("TransR", dict(no_eval_filter=True)),
    ("TransE_l2", dict(neg_sample_size_eval=50, batch_size_eval=3))],
    ids=["TransE_l2", "TransR_raw", "sampled"])
def test_host_eval_on_the_stand_in_card(datasets, monkeypatch, name, over):
    """Two Test evals on the graph route of a stand-in card: the ranks of
    the eager route, each eval's graph line those of its keys' calls (a
    key captured at its second call, replayed from there), and the blocks
    replayed from the captured calls at their own places."""
    pcfg, eager, _, _ = _models(name, **over)
    pstate, _ = _states(eager)
    got = _ranks_of(monkeypatch, ptrainer, "combine_rank_metrics")
    pht.evaluate_host(pcfg, datasets[0], eager, pstate, "test", log=QUIET)
    live = _stand_in_card(monkeypatch)
    model = KEModel(pcfg, N_ENT, N_REL, device="cpu")
    live.append(model.eval_calls)
    lines = []
    for _ in range(2):
        pht.evaluate_host(pcfg, datasets[0], model, pstate, "test",
                          log=lines.append)
    want, first, second = got
    np.testing.assert_array_equal(first, want)
    np.testing.assert_array_equal(second, want)
    graphs = [x for x in lines if "eval CUDA graphs" in x]
    if "neg_sample_size_eval" in over:
        # 34 batches a mode: two groups of 32 a call shape and mode
        assert graphs == ["[0]Test eval CUDA graphs: 2 captured, 2 replays",
                          "[0]Test eval CUDA graphs: 0 captured, 4 replays"]
    else:
        # the pos/side calls (one a direction) capture in the second eval;
        # the blocks (two a buffer) in the first, at their second call
        assert graphs == ["[0]Test eval CUDA graphs: 2 captured, 2 replays",
                          "[0]Test eval CUDA graphs: 2 captured, 6 replays"]
        assert _block_calls(model.eval_calls) == {0: 4, 1: 4}
    calls = model.eval_calls
    assert calls.captured == sum(n >= 2 for n in calls.keys.values())
    assert calls.replays == sum(n - 1 for n in calls.keys.values())


def test_full_eval_needs_a_mapped_table_on_a_card(datasets, monkeypatch):
    """On a card the staging copy reads the mapped table: a host table
    that is not mapped raises before any block is streamed."""
    pcfg, pm, _, _ = _models("TransE_l2")
    pstate, _ = _states(pm)
    calls = pm.eval_calls
    hb = calls.host_blocks(pstate, [dict(
        neg_head=True, pos=torch.zeros(4), side=torch.zeros(4, DIM),
        rel=torch.zeros(4, DIM), proj=None,
        fid=torch.zeros((4, 8), dtype=torch.int32),
        fm=torch.zeros((4, 8), dtype=torch.uint8))],
        [4], BLOCK, Q_MIN, "Test")
    monkeypatch.setattr(pm, "device", torch.device("cuda", 0))
    with pytest.raises(ValueError, match="not mapped"):
        pht._stream_blocks(pm, pstate, calls, hb, BLOCK, Q_MIN)
