"""Every flag of the JAX package's CLIs parses in dglke_tpu_torch's
(train, eval, predict, emb_sim, convert), found by introspecting both
parsers, and means the same value; the flags that select nothing on one
device print the JAX package's NOTE lines.  The modes ported since they
were first refused (--mix_cpu_gpu; --dist, --sharded_ckpt,
--partition_path; --compute_dtype bfloat16, --profile) are accepted and
reach their config field or the trainer, and --dist with --mix_cpu_gpu is
refused before anything runs, as in the JAX package.
examples/freebase.sh's command lines (--table_sharding vocab) parse and
pass the refusals.
"""

import argparse
import os
import shlex

import pytest

import jax  # noqa: F401  (on the CPU: tests/conftest.py)

from dglke_tpu.cli import convert as jconvert
from dglke_tpu.cli import emb_sim as jemb_sim
from dglke_tpu.cli import eval as jeval
from dglke_tpu.cli import predict as jpredict
from dglke_tpu.cli import train as jtrain
from dglke_tpu_torch.cli import args as pargs
from dglke_tpu_torch.cli import convert as pconvert
from dglke_tpu_torch.cli import emb_sim as pemb_sim
from dglke_tpu_torch.cli import eval as peval
from dglke_tpu_torch.cli import predict as ppredict
from dglke_tpu_torch.cli import train as ptrain

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLIS = {"train": (jtrain.main, ptrain.main), "eval": (jeval.main, peval.main),
        "predict": (jpredict.main, ppredict.main),
        "emb_sim": (jemb_sim.main, pemb_sim.main),
        "convert": (jconvert.main, pconvert.main)}
# what each parser requires before anything else parses
REQUIRED = {"predict": ["--format", "h_r_t"], "emb_sim": ["--format", "*"],
            "convert": ["--data_path", "d", "--data_files", "f"]}


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch) -> argparse.ArgumentParser:
    """The parser a CLI's main builds, caught at its parse_args."""
    seen = {}

    def grab(self, args=None, namespace=None):
        seen["parser"] = self
        raise _Parsed

    with monkeypatch.context() as m:
        m.setattr(argparse.ArgumentParser, "parse_args", grab)
        with pytest.raises(_Parsed):
            main([])
    return seen["parser"]


def _value_for(action) -> list:
    """Arguments that set ``action`` to something other than its default."""
    if action.nargs == 0:
        return []
    if action.choices:
        return [str(list(action.choices)[-1])]
    return {int: ["3"], float: ["0.5"]}.get(action.type, ["x"])


@pytest.mark.parametrize("cli", list(CLIS))
def test_every_jax_flag_parses_in_the_port(monkeypatch, cli):
    jax_parser, port_parser = (_parser_of(m, monkeypatch) for m in CLIS[cli])
    checked = 0
    for action in jax_parser._actions:
        if isinstance(action, argparse._HelpAction):
            continue
        for opt in action.option_strings:
            argv = REQUIRED.get(cli, []) + [opt] + _value_for(action)
            want = getattr(jax_parser.parse_args(argv), action.dest)
            got = getattr(port_parser.parse_args(argv), action.dest)
            assert got == want, (cli, opt, got, want)
            checked += 1
    assert checked >= {"train": 60, "eval": 50, "predict": 11,
                       "emb_sim": 10, "convert": 8}[cli]


def _train_args(*flags):
    p = argparse.ArgumentParser()
    pargs.add_common_args(p)
    pargs.add_train_args(p)
    return p.parse_args(list(flags))


def _eval_args(monkeypatch, *flags):
    return _parser_of(peval.main, monkeypatch).parse_args(list(flags))


NOTES = {
    ("--gpu", "0"): "--gpu is a compatibility no-op",
    ("--num_proc", "4"): "--num_proc is a compatibility no-op",
    ("--num_thread", "4"): "--num_thread is a compatibility no-op",
    ("--force_sync_interval", "100"): "--force_sync_interval is a "
                                      "compatibility no-op",
    ("--rel_part",): "--rel_part only takes effect with --dist",
    ("--table_sharding", "vocab"): "--table_sharding vocab has no effect on "
                                   "one device",
}


@pytest.mark.parametrize("flags", list(NOTES), ids=lambda f: f[0])
def test_inert_flags_print_one_note(flags):
    lines = []
    args = _train_args(*flags)
    pargs.refuse_unported(args)
    pargs.warn_inert_flags(args, log=lines.append)
    assert len(lines) == 1 and NOTES[flags] in lines[0], lines
    quiet = []
    pargs.warn_inert_flags(_train_args(), log=quiet.append)
    assert quiet == []


# Modes ported since they were first refused: accepted, with their NOTE
# line (None: no line) and the (config field, value) they set, if any.
# --profile is no config field: it reaches the trainer as profile_dir.
PORTED = {"--mix_cpu_gpu": ("--mix_cpu_gpu keeps tables in host memory",
                            ("mix_cpu_gpu", True)),
          "--dist": (None, None),
          "--sharded_ckpt": (None, None),
          "--partition_path": ("--partition_path only takes effect with "
                               "--dist", None),
          "--profile": (None, None),
          "--compute_dtype": (None, ("compute_dtype", "bfloat16"))}


@pytest.mark.parametrize("flags,item", [
    (("--partition_path", "parts"), None),
    (("--dist",), None),
    (("--sharded_ckpt",), None),
    (("--mix_cpu_gpu",), None),
    (("--profile", "trace"), None),
    (("--compute_dtype", "bfloat16"), None),
], ids=lambda f: f[0] if isinstance(f, tuple) else None)
def test_unported_train_flags_are_refused(flags, item):
    """Every mode once refused is accepted now, with its NOTE line and its
    config field."""
    note, field = PORTED[flags[0]]
    lines = []
    pargs.refuse_unported(_train_args(*flags))
    pargs.warn_inert_flags(_train_args(*flags), log=lines.append)
    assert lines == [] if note is None else (
        len(lines) == 1 and note in lines[0]), lines
    if field is not None:
        cfg = pargs.config_from_args(_train_args(*flags))
        assert getattr(cfg, field[0]) == field[1]
        assert getattr(pargs.config_from_args(_train_args()),
                       field[0]) != field[1]


def test_profile_reaches_the_trainer(monkeypatch, tmp_path):
    """--profile DIR is passed to trainer.train as profile_dir (the JAX
    package's cli/train.py:226-228)."""
    seen = {}

    def fake_train(*a, **k):
        seen.update(k)
        raise _Parsed

    monkeypatch.setattr(ptrain, "train", fake_train)
    monkeypatch.setattr(ptrain, "get_dataset", lambda *a, **k: _tiny_kg())
    with pytest.raises(_Parsed):
        ptrain.main(["--device", "cpu", "--profile", str(tmp_path / "tr"),
                     "--save_path", str(tmp_path / "ck"),
                     "--hidden_dim", "4"])
    assert seen["profile_dir"] == str(tmp_path / "tr")


def _tiny_kg():
    from dglke_tpu_torch.data.dataset import synthetic_dataset
    return synthetic_dataset(n_entities=20, n_relations=2, n_train=40,
                             n_valid=4, n_test=4)


@pytest.mark.parametrize("flags,item", [
    (("--mix_cpu_gpu",), None), (("--dist",), None),
    (("--compute_dtype", "bfloat16"), None)],
    ids=lambda f: f[0] if isinstance(f, tuple) else None)
def test_unported_eval_flags_are_refused(monkeypatch, tmp_path, flags, item):
    """Accepted: the eval goes on to start its rank (--dist) or to read its
    dataset; --compute_dtype bfloat16 has no effect on eval, as in the JAX
    package."""
    def reached(*a, **k):
        raise _Parsed

    monkeypatch.setattr(peval, "get_dataset", reached)
    monkeypatch.setattr(peval, "init_distributed", reached)
    with pytest.raises(_Parsed):
        peval.main(["--model_path", str(tmp_path), "--device", "cpu",
                    *flags])
    args = _eval_args(monkeypatch, "--no_mix_cpu_gpu", "--table_sharding",
                      "vocab", "--gpu", "0", "1", *flags)
    pargs.refuse_unported(args)
    assert args.gpu == [0, 1]


def _freebase_lines():
    text = open(os.path.join(ROOT, "examples", "freebase.sh")).read()
    text = text.replace("\\\n", " ")
    return [shlex.split(ln)[1:] for ln in text.splitlines()
            if ln.startswith("dglke_tpu-train ")]


@pytest.mark.parametrize("i", range(3))
def test_freebase_example_lines_parse(i):
    lines = _freebase_lines()
    assert len(lines) == 3
    args = _train_args(*lines[i])
    assert args.table_sharding == "vocab" and args.dataset == "Freebase"
    pargs.refuse_unported(args)
    notes = []
    pargs.warn_inert_flags(args, log=notes.append)
    assert notes == ["NOTE: --table_sharding vocab has no effect on one "
                     "device"]
    assert pargs.config_from_args(args).model_name == args.model_name


@pytest.mark.parametrize("cli", ["train", "eval"])
def test_dist_with_mix_cpu_gpu_is_refused_before_anything_runs(
        monkeypatch, tmp_path, cli):
    """The JAX package's refusal (cli/train.py:42-49): host tables live in
    one host's memory.  Refused before the process group starts."""
    def started(*a, **k):
        raise AssertionError("the rank started")

    main = {"train": ptrain, "eval": peval}[cli]
    monkeypatch.setattr(main, "init_distributed", started)
    argv = ["--dist", "--mix_cpu_gpu", "--device", "cpu"]
    if cli == "eval":
        argv += ["--model_path", str(tmp_path)]
    with pytest.raises(SystemExit, match="--mix_cpu_gpu is a single-host "
                                         "mode"):
        main.main(argv)


def test_dist_notes_are_not_printed_under_dist():
    """--rel_part, --table_sharding vocab and --partition_path select
    something under --dist: no NOTE there."""
    lines = []
    pargs.warn_inert_flags(_train_args(
        "--dist", "--rel_part", "--table_sharding", "vocab",
        "--partition_path", "parts"), log=lines.append)
    assert lines == []
    cfg = pargs.config_from_args(_train_args("--dist", "--rel_part",
                                             "--table_sharding", "vocab"))
    assert (cfg.rel_part, cfg.table_sharding) == (True, "vocab")


def test_dist_save_interval_needs_sharded_ckpt(monkeypatch, tmp_path):
    """--save_interval under --dist of several ranks requires
    --sharded_ckpt (the JAX package's cli/train.py:203-208), refused once
    the rank knows the world size, before any dataset is read."""
    import types
    comm = types.SimpleNamespace(world=2, device=None, close=lambda: None)
    monkeypatch.setattr(ptrain, "init_distributed", lambda device: comm)
    with pytest.raises(SystemExit, match="requires --sharded_ckpt"):
        ptrain.main(["--dist", "--device", "cpu", "--save_interval", "10",
                     "--save_path", str(tmp_path)])
    assert not os.listdir(tmp_path)
