"""The numbers that decide ``correct`` and how they are judged.

Training, against the reference's steps from the same seed, on two group
calls of the window's own call and feed (s steps a call):

- the first call, which runs its steps eagerly: each of the first three
  steps' loss (``loss_gap``), the first gradient as Adagrad got it,
  worked out from the tables and state after step 1 (``grad_gap``: g =
  -(w1 - w0) (sqrt(s1) + 1e-10) / lr per row), and the tables' change
  after three steps (``change_gap``);
- the third call, steps 2s + 1 to 3s, the second replay of the captured
  graph (the second call captures it and replays it once): each of its
  steps' loss (``replay_loss_gap``), the change of the Adagrad state
  across it, the squared gradients it summed (``replay_state_gap``), and
  the tables' change across it (``replay_change_gap``).

Losses are compared by the largest relative gap.  The rest are norms by
the worst table ("leaf"): |norm(program) - norm(reference)| over the
larger of the reference's norm of that leaf and of the median leaf.  A
leaf whose reference gradient is under a thousandth of the median leaf's
moves by round-off alone and is left out of the changes.
"""

from __future__ import annotations

import statistics

import torch

BLOCK_ELEMENTS = 1 << 22   # a block of rows compared on the card at once


def _norm(x) -> float:
    return float(torch.linalg.vector_norm(x.double()))


def leaf_norms(device, tables, fn) -> float:
    """sqrt(sum over row blocks of ||fn(*block)||^2) over host or device
    ``tables`` of one leaf, moved to ``device`` a block at a time."""
    total = 0.0
    rows = tables[0].shape[0]
    step = max(1, BLOCK_ELEMENTS // max(1, tables[0][0].numel()))
    for at in range(0, rows, step):
        parts = [t[at:at + step].to(device, non_blocking=False)
                 for t in tables]
        total += _norm(fn(*parts)) ** 2
    return total ** 0.5


def _grad(lr):
    return lambda w0, w1, s1: -(w1 - w0) * (
        torch.sqrt(s1.reshape(-1, *([1] * (w1.dim() - 1)))) + 1e-10) / lr


def marks(s: int) -> tuple:
    """The step counts after which both sides keep the tables and the
    Adagrad states, for groups of ``s`` steps."""
    return (0, 1, 3, 2 * s, 3 * s)


def train_readings(side: dict, lr: float, s: int, device) -> dict:
    """Per leaf, the norms the check compares, from a side's snapshots
    (side[k] = {"w": tables, "s": states} after k steps, each a list over
    the leaves) and its losses (side["loss"][i]: step i + 1's)."""
    at = {k: side[k] for k in marks(s)}
    out = {k: [] for k in ("grad", "change", "replay_state",
                           "replay_change")}
    for leaf in range(len(at[0]["w"])):
        w0, w1, s1, w3 = (at[0]["w"][leaf], at[1]["w"][leaf],
                          at[1]["s"][leaf], at[3]["w"][leaf])
        out["grad"].append(leaf_norms(device, [w0, w1, s1], _grad(lr)))
        out["change"].append(leaf_norms(device, [w0, w3], _minus))
        a, b = at[2 * s], at[3 * s]
        out["replay_state"].append(
            leaf_norms(device, [a["s"][leaf], b["s"][leaf]], _minus))
        out["replay_change"].append(
            leaf_norms(device, [a["w"][leaf], b["w"][leaf]], _minus))
    loss = side["loss"]
    out["loss"] = [loss[i] for i in range(3)]
    out["replay_loss"] = [loss[i] for i in range(2 * s, 3 * s)]
    return out


def _minus(a, b):
    return b - a


def worst_leaf_gap(prog: list, ref: list, keep=None) -> float:
    median = statistics.median(ref)
    gaps = [abs(p - r) / max(r, median, 1e-30)
            for i, (p, r) in enumerate(zip(prog, ref))
            if keep is None or keep[i]]
    return max(gaps) if gaps else 0.0


def loss_gap(prog: list, ref: list) -> float:
    if any(p != p for p in prog):      # a NaN loss
        return float("inf")
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def train_numbers(prog: dict, ref: dict) -> dict:
    """The training numbers of a program's readings against the
    reference's (each from train_readings)."""
    median = statistics.median(ref["grad"])
    moved = [g >= 1e-3 * median for g in ref["grad"]]
    return {"loss_gap": loss_gap(prog["loss"], ref["loss"]),
            "grad_gap": worst_leaf_gap(prog["grad"], ref["grad"]),
            "change_gap": worst_leaf_gap(prog["change"], ref["change"],
                                         moved),
            "replay_loss_gap": loss_gap(prog["replay_loss"],
                                        ref["replay_loss"]),
            "replay_state_gap": worst_leaf_gap(prog["replay_state"],
                                               ref["replay_state"]),
            "replay_change_gap": worst_leaf_gap(prog["replay_change"],
                                                ref["replay_change"], moved)}


def judge(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): each number at or under its
    limit; a number without a limit, or a NaN, fails."""
    rows, ok = [], True
    for name, value in numbers.items():
        limit = limits.get(name)
        good = limit is not None and value == value and value <= limit
        ok = ok and good
        rows.append((name, value, limit))
    return ok, rows
