"""Every flag of the JAX package's CLIs parses in dglke_tpu_torch's
(train, eval, predict, emb_sim, convert), found by introspecting both
parsers, and means the same value; the flags that select nothing on one
device print the JAX package's NOTE lines, and the modes the port does not
run are refused with their ROADMAP item.  examples/freebase.sh's command
lines (--table_sharding vocab) parse and pass the refusals.
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
# line (None: ported, and not refused).
PORTED = {"--mix_cpu_gpu": "--mix_cpu_gpu keeps tables in host memory"}


@pytest.mark.parametrize("flags,item", [
    (("--partition_path", "parts"), "A11"),
    (("--dist",), "A11"),
    (("--sharded_ckpt",), "A11"),
    (("--mix_cpu_gpu",), None),
    (("--profile", "trace"), "A6b"),
    (("--compute_dtype", "bfloat16"), "§C, deliberate"),
], ids=lambda f: f[0] if isinstance(f, tuple) else None)
def test_unported_train_flags_are_refused(flags, item):
    if flags[0] in PORTED:
        lines = []
        pargs.refuse_unported(_train_args(*flags))
        pargs.warn_inert_flags(_train_args(*flags), log=lines.append)
        assert len(lines) == 1 and PORTED[flags[0]] in lines[0], lines
        assert pargs.config_from_args(_train_args(*flags)).mix_cpu_gpu
        return
    with pytest.raises(SystemExit, match=f"ROADMAP item {item}"):
        pargs.refuse_unported(_train_args(*flags))
    pargs.refuse_unported(_train_args("--compute_dtype", "float32"))


@pytest.mark.parametrize("flags,item", [
    (("--mix_cpu_gpu",), None), (("--dist",), "A11"),
    (("--compute_dtype", "bfloat16"), "§C, deliberate")],
    ids=lambda f: f[0] if isinstance(f, tuple) else None)
def test_unported_eval_flags_are_refused(monkeypatch, tmp_path, flags, item):
    if flags[0] in PORTED:
        # accepted: the eval goes on to read its dataset
        def reached(*a, **k):
            raise _Parsed

        monkeypatch.setattr(peval, "get_dataset", reached)
        with pytest.raises(_Parsed):
            peval.main(["--model_path", str(tmp_path), "--device", "cpu",
                        *flags])
        return
    with pytest.raises(SystemExit, match=f"ROADMAP item {item}"):
        peval.main(["--model_path", str(tmp_path), "--device", "cpu",
                    *flags])
    args = _eval_args(monkeypatch, "--no_mix_cpu_gpu", "--table_sharding",
                      "vocab", "--gpu", "0", "1")
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
