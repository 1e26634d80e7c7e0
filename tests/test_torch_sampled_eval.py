"""dglke_tpu_torch's sampled-negative eval (--neg_sample_size_eval, the
protocol of the wikikg2, biokg and Freebase recipes) against the JAX
package's, on the same numpy tables and the same seeds.

The samplers must emit identical batches (the same negatives, bit for bit,
for the same seed, rank and mode) and identical false-negative masks.
Ranks must be identical wherever a row's kept candidates hold no copy of
its true entity.  Unfiltered, a sampled negative (or, under
neg_deg_sample, another row's own entity) can be the true entity itself;
its score then equals the positive score up to rounding, each framework
rounds the two formulas its own way, and the rank may differ by one for
each such copy (ROADMAP, section C).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from dglke_tpu.config import KGEConfig as JaxConfig
from dglke_tpu.data.dataset import synthetic_dataset as jax_synthetic
from dglke_tpu.data.sampler import EvalSampler as JaxSampler
from dglke_tpu.data.sampler import FilterIndex as JaxFilter
from dglke_tpu.models.ke_model import KEModel as JaxModel
from dglke_tpu.trainer import evaluate as jax_evaluate
from dglke_tpu_torch.config import KGEConfig
from dglke_tpu_torch.data.dataset import synthetic_dataset
from dglke_tpu_torch.data.sampler import EvalSampler, FilterIndex
from dglke_tpu_torch.models.ke_model import KEModel
from dglke_tpu_torch.trainer import EVAL_GROUP, evaluate
from dglke_tpu_torch.utils.convert import state_from_numpy

torch.set_num_threads(2)

N_ENT, N_REL, DIM, K, B = 200, 5, 8, 24, 16
QUIET = lambda *a: None  # noqa: E731
FAMILIES = {"TransE_l2": {}, "TransE_l1": {}, "TransR": {}, "DistMult": {},
            "ComplEx": {}, "RESCAL": {}, "RotatE": dict(double_ent=True),
            "SimplE": {}}
# 1,000 train and 50 test triples: the test split ends in a partial batch
# of 2 rows at batch 16
DATA = dict(n_entities=N_ENT, n_relations=N_REL, n_train=1000, n_valid=50,
            n_test=50, seed=0)
JDS, PDS = jax_synthetic(**DATA), synthetic_dataset(**DATA)


def _pair(name, **over):
    kw = dict(model_name=name, hidden_dim=DIM, gamma=4.0, batch_size_eval=B,
              **FAMILIES[name], **over)
    jcfg, pcfg = JaxConfig(**kw), KGEConfig(**kw)
    jm = JaxModel(jcfg, N_ENT, N_REL)
    pm = KEModel(pcfg, N_ENT, N_REL, device="cpu")
    jstate = jax.device_get(jm.init_state(jax.random.PRNGKey(1)))
    return jcfg, jm, jstate, pcfg, pm, state_from_numpy(jstate,
                                                          device="cpu")


def _samplers(mode, filtered, deg=False, **kw):
    args = dict(neg_sample_size=K, neg_deg_sample=deg, **kw)
    return (JaxSampler(JDS, "test", B, mode,
                       JaxFilter(JDS) if filtered else None, **args),
            EvalSampler(PDS, "test", B, mode,
                        FilterIndex(PDS) if filtered else None, **args))


@pytest.mark.parametrize("deg", [False, True], ids=["uniform", "deg"])
@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("rank,ranks", [(0, 1), (1, 2)])
@pytest.mark.parametrize("seed", [0, 5])
def test_sampled_batches_identical(seed, rank, ranks, mode, deg):
    """neg, neg_keep and the padded tail batch are the JAX package's, bit
    for bit, for the same seed, rank and mode."""
    jsam, psam = _samplers(mode, not deg, deg, seed=seed, rank=rank,
                           ranks=ranks)
    jb, pb = list(jsam), list(psam)
    assert len(pb) == len(jb) == len(psam) > 1
    for j, p in zip(jb, pb):
        assert set(p) == set(j)
        for k in j:
            np.testing.assert_array_equal(np.asarray(p[k]), np.asarray(j[k]))
    assert "neg_keep" in pb[0] and pb[0]["neg_keep"].shape == (B, K) \
        if not deg else "neg_keep" not in pb[0]


@pytest.mark.parametrize("mode", ["head", "tail"])
def test_false_neg_mask_identical_and_exact(mode):
    """The keep-mask equals the JAX package's, and zeroes exactly the
    negatives that form a true triple with the row."""
    jfi, pfi = JaxFilter(JDS), FilterIndex(PDS)
    rng = np.random.RandomState(3)
    h, r, t = (np.asarray(x[:B]) for x in PDS.test)
    neg = rng.randint(0, N_ENT, 64).astype(np.int32)
    neg[:B] = h if mode == "head" else t         # every row's own entity
    keep = pfi.false_neg_mask(mode, h, r, t, neg)
    np.testing.assert_array_equal(keep, jfi.false_neg_mask(mode, h, r, t,
                                                           neg))
    true = {(int(a), int(b), int(c)) for split in (PDS.train, PDS.valid,
                                                   PDS.test)
            for a, b, c in zip(*split[:3])}
    for i in range(B):
        for j, e in enumerate(neg):
            tri = ((int(e), int(r[i]), int(t[i])) if mode == "head"
                   else (int(h[i]), int(r[i]), int(e)))
            assert keep[i, j] == (0 if tri in true else 1)
    assert all(keep[i, i] == 0 for i in range(B))
    np.testing.assert_array_equal(
        pfi.true_tails(int(h[0]), int(r[0])),
        jfi.true_tails(int(h[0]), int(r[0])))
    np.testing.assert_array_equal(
        pfi.true_heads(int(r[0]), int(t[0])),
        jfi.true_heads(int(r[0]), int(t[0])))


def _twins(ent, pb, deg):
    """Per row: kept candidates whose table row equals the true entity's
    (the self-tie, a near tie whatever the family)."""
    true = pb["h"] if pb["neg_head"] else pb["t"]
    cand = pb["neg"]
    own = np.zeros((B, 0), bool)
    if deg:
        own_ids = pb["h"] if pb["neg_head"] else pb["t"]
        own = (ent[own_ids][None, :, :] == ent[true][:, None, :]).all(-1)
        own &= ~np.eye(B, dtype=bool)
        own[:, pb["n_valid"]:] = False
    same = (ent[cand][None, :, :] == ent[true][:, None, :]).all(-1)
    if "neg_keep" in pb:
        same &= pb["neg_keep"] > 0
    return np.concatenate([own, same], axis=1).sum(1)


@pytest.mark.parametrize("filtered,deg", [(True, False), (False, False),
                                          (False, True)],
                         ids=["filtered", "raw", "raw_deg"])
@pytest.mark.parametrize("mode", ["head", "tail"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_eval_ranks_sampled_identical(name, mode, filtered, deg):
    """eval_ranks_sampled batch by batch against the JAX package's: the
    real rows' ranks identical, but for the self-ties of raw ranking."""
    _, jm, jstate, _, pm, pstate = _pair(name)
    jsam, psam = _samplers(mode, filtered, deg)
    ent = np.asarray(jstate.entity.emb)
    equal = 0
    for jb, pb in zip(jsam, psam):
        keep = jb.get("neg_keep", np.ones((B, K), np.uint8))
        want = np.asarray(jm.eval_ranks_sampled(
            jstate, jb["h"], jb["r"], jb["t"], jb["neg"], keep,
            neg_head=jb["neg_head"], neg_deg_sample=deg,
            n_valid=jb["n_valid"]))
        got = pm.eval_ranks_sampled(
            pstate, *(torch.from_numpy(pb[k]) for k in ("h", "r", "t",
                                                         "neg")),
            torch.from_numpy(pb["neg_keep"]) if filtered else None,
            neg_head=pb["neg_head"], neg_deg_sample=deg,
            n_valid=pb["n_valid"]).numpy()
        nv = pb["n_valid"]
        twins = _twins(ent, pb, deg)[:nv]
        diff = np.abs(got[:nv] - want[:nv])
        assert np.all(diff <= twins), (got, want, twins)
        assert np.all(diff[twins == 0] == 0)
        equal += int((diff == 0).sum())
    if filtered:
        assert equal == len(PDS.test[0])
    assert equal >= len(PDS.test[0]) - 6


@pytest.mark.parametrize("name", ["TransE_l2", "TransR", "RESCAL"])
@pytest.mark.parametrize("deg", [False, True], ids=["uniform", "deg"])
def test_grouped_ranks_equal_batch_by_batch(name, deg):
    """Ranking a group of batches in one call (the trainer's form) gives
    each row the rank it gets alone, the partial tail batch included."""
    _, _, _, _, pm, pstate = _pair(name)
    _, psam = _samplers("tail", not deg, deg)
    batches = list(psam)
    assert batches[-1]["n_valid"] < B

    def stack(k):
        return torch.from_numpy(np.stack([b[k] for b in batches]))

    grouped = pm.eval_ranks_sampled(
        pstate, stack("h"), stack("r"), stack("t"), stack("neg"),
        None if deg else stack("neg_keep"), neg_head=False,
        neg_deg_sample=deg,
        n_valid=torch.tensor([b["n_valid"] for b in batches]))
    assert grouped.shape == (len(batches), B)
    for i, b in enumerate(batches):
        alone = pm.eval_ranks_sampled(
            pstate, *(torch.from_numpy(b[k]) for k in ("h", "r", "t",
                                                        "neg")),
            None if deg else torch.from_numpy(b["neg_keep"]),
            neg_head=False, neg_deg_sample=deg, n_valid=b["n_valid"])
        nv = b["n_valid"]
        torch.testing.assert_close(grouped[i, :nv], alone[:nv], rtol=0,
                                   atol=0)


def test_neg_deg_sample_quirk_and_padding():
    """Under neg_deg_sample the diagonal is zeroed and still compared with
    the positive score, and a padded row's own-node columns are masked."""
    _, _, _, _, pm, pstate = _pair("DistMult")
    rng = np.random.RandomState(0)
    ent = pstate.entity.emb
    # distinct entities everywhere, so no candidate is a near tie
    ids = torch.from_numpy(rng.permutation(N_ENT)[:2 * B + K].astype(
        np.int32))
    h, t, neg = ids[:B], ids[B:2 * B], ids[2 * B:]
    r = torch.from_numpy(rng.randint(0, N_REL, B).astype(np.int32))
    rows = [ent[x.long()] for x in (h, t)]
    rel = pstate.relation.emb[r.long()]
    negr = ent[neg.long()]
    ranks = pm._rows_eval_ranks_sampled(rows[0], rows[1], rel, None, negr,
                                        None, neg_head=False,
                                        neg_deg_sample=True, n_valid=5)
    pos = torch.sum(rows[0] * rel * rows[1], dim=1)
    s_own = (rows[0] * rel) @ rows[1].T
    s_own.fill_diagonal_(0.0)
    s_own[:, 5:] = -float("inf")                 # padded columns masked
    s_neg = (rows[0] * rel) @ negr.T
    want = ((s_own >= pos[:, None]).sum(1) + (s_neg >= pos[:, None]).sum(1)
            + 1)
    torch.testing.assert_close(ranks, want, rtol=0, atol=0)
    assert bool((pos[:5] <= 0).any() and (pos[:5] > 0).any())


def test_k_at_least_n_entities_falls_back_to_full_ranking():
    pcfg = KGEConfig(model_name="TransE_l2", hidden_dim=DIM, gamma=4.0,
                     batch_size_eval=B, neg_sample_size_eval=N_ENT)
    jcfg = JaxConfig(model_name="TransE_l2", hidden_dim=DIM, gamma=4.0,
                     batch_size_eval=B, neg_sample_size_eval=N_ENT)
    b = next(iter(EvalSampler(PDS, "test", B, "tail",
                              neg_sample_size=N_ENT)))
    assert "neg" not in b
    jm = JaxModel(jcfg, N_ENT, N_REL)
    jstate = jax.device_get(jm.init_state(jax.random.PRNGKey(1)))
    pm = KEModel(pcfg, N_ENT, N_REL, device="cpu")
    pstate = state_from_numpy(jstate, device="cpu")
    full = evaluate(dataclasses.replace(pcfg, neg_sample_size_eval=-1),
                    PDS, pm, pstate, "test", log=QUIET)
    got = evaluate(pcfg, PDS, pm, pstate, "test", log=QUIET)
    assert got == full
    assert got == jax_evaluate(jcfg, JDS, jm, jstate, "test", log=QUIET)


@pytest.mark.parametrize("name", ["TransE_l2", "DistMult", "TransR",
                                  "ComplEx"])
def test_evaluate_metrics_identical(name):
    """Filtered sampled eval through evaluate(), both modes: the same
    metrics as the JAX package on identical tables (grouped ranking in
    the port, vmapped groups of 32 in the JAX package)."""
    jcfg, jm, jstate, pcfg, pm, pstate = _pair(name, neg_sample_size_eval=K)
    want = jax_evaluate(jcfg, JDS, jm, jstate, "test", log=QUIET)
    logs = []
    got = evaluate(pcfg, PDS, pm, pstate, "test", log=logs.append)
    assert got == want
    assert any(x.startswith("[0]Test average MRR") for x in logs)


def test_evaluate_groups_span_several_calls(monkeypatch):
    """A split of more batches than one group: the metrics do not depend
    on where the groups are cut."""
    import dglke_tpu_torch.trainer as pt_trainer
    _, _, _, pcfg, pm, pstate = _pair("TransE_l2", neg_sample_size_eval=K)
    whole = evaluate(pcfg, PDS, pm, pstate, "test", log=QUIET)
    calls = []
    real = pm.eval_ranks_sampled

    def counted(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(pm, "eval_ranks_sampled", counted)
    monkeypatch.setattr(pt_trainer, "EVAL_GROUP", 2)
    assert evaluate(pcfg, PDS, pm, pstate, "test", log=QUIET) == whole
    assert [c[0] for c in calls] == [2, 2] * 2
    assert EVAL_GROUP == 32


def test_eval_cli_sampled_matches_jax(tmp_path, capsys):
    """A checkpoint written by the JAX package, evaluated by both eval
    CLIs with --neg_sample_size_eval (filtered): the same metrics."""
    from dglke_tpu.cli.eval import main as jax_eval_main
    from dglke_tpu.utils.io import save_model as jax_save_model
    from dglke_tpu_torch.cli.eval import main as eval_main
    data = tmp_path / "data"
    data.mkdir()
    (data / "entities.tsv").write_text(
        "".join(f"{i}\te{i}\n" for i in range(N_ENT)))
    (data / "relations.tsv").write_text(
        "".join(f"{i}\tr{i}\n" for i in range(N_REL)))
    for split in ("train", "valid", "test"):
        np.savetxt(data / f"{split}.tsv",
                   np.stack(getattr(PDS, split)[:3], axis=1), fmt="%d",
                   delimiter="\t")
    ckpt = tmp_path / "ckpt"
    jcfg, jm, jstate, _, _, _ = _pair("TransE_l2")
    jcfg.save_path = str(ckpt)
    jcfg.dataset = "kg"
    jax_save_model(jcfg, jm, jstate)
    argv = ["--data_path", str(data), "--format", "udd_hrt",
            "--data_files", "entities.tsv", "relations.tsv", "train.tsv",
            "valid.tsv", "test.tsv", "--model_path", str(ckpt),
            "--batch_size_eval", str(B), "--neg_sample_size_eval", str(K)]

    def metrics(out):
        return {line.split("average ")[1].split(":")[0]:
                float(line.rsplit(":", 1)[1]) for line in out.splitlines()
                if line.startswith("[0]Test average")}

    capsys.readouterr()
    assert jax_eval_main(argv) == 0
    want = metrics(capsys.readouterr().out)
    assert eval_main(argv + ["--device", "cpu"]) == 0
    got = metrics(capsys.readouterr().out)
    assert set(got) == {"MRR", "MR", "HITS@1", "HITS@3", "HITS@10"}
    assert got == want
