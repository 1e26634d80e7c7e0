"""The first training steps of a cell, in plain PyTorch, from the seed.

Each step follows dgl-ke's recipe as the configuration states it: gather
the rows of [h | t | negatives] and, by the relations, the rows of every
relation-keyed table (the relation table, then any further one the family
declares, as TransR's projection), score the positives and each chunk's
shared negatives, take the self-adversarial Logsigmoid loss plus
``regularization_coef`` x the sum of |row|^p over the gathered entity and
relation rows (dgl-ke regularizes those two tables only), differentiate
with respect to the gathered rows, and write every table back through
row-sparse Adagrad (state += mean(g^2) per occurrence, then row -= lr g /
(sqrt(state) + 1e-10)).  Returns every step's loss and the tables with
their Adagrad states after each step count the check reads.

A family's module (``reference/<family>.py``) declares its tables,
``tables(hidden, emb_init)``: [(width, init range)] in the port's draw
order, the entity table first; its ``pos_score`` and ``neg_scores`` take
the rows of the tables past the relation table as further arguments."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kgbench.reference.streams import Batches, init_tables, table_shapes


def loss_of(pos, neg, flags):
    pos_loss = torch.mean(-F.logsigmoid(pos))
    neg_loss = -F.logsigmoid(-neg)
    if flags.get("neg_adversarial_sampling"):
        adv = torch.softmax(
            neg * flags.get("adversarial_temperature", 1.0), dim=-1).detach()
        neg_loss = torch.sum(adv * neg_loss, dim=-1)
    else:
        neg_loss = torch.mean(neg_loss, dim=-1)
    return (pos_loss + torch.mean(neg_loss)) / 2.0


def adagrad(table, state, ids, grads, lr):
    state.index_add_(0, ids, torch.mean(grads * grads, dim=1))
    std = torch.sqrt(state[ids]) + 1e-10
    table.index_add_(0, ids, -lr * grads / std[:, None])


def step_loss_and_grads(family, flags, tables, h, r, t, neg, neg_head):
    """(loss, entity ids, the gradients of each table's gathered rows):
    ``tables`` is [entity, relation, further relation-keyed tables]."""
    b = h.shape[0]
    chunks = max(1, b // min(flags["neg_sample_size"], b))
    ent_ids = torch.cat([h, t, neg.long()])
    ent_rows = tables[0][ent_ids].detach().requires_grad_()
    rel_rows = [table[r].detach().requires_grad_() for table in tables[1:]]
    with torch.enable_grad():
        h_rows, t_rows = ent_rows[:b], ent_rows[b:2 * b]
        pos = family.pos_score(h_rows, rel_rows[0], t_rows, flags,
                               *rel_rows[1:])
        side = t_rows if neg_head else h_rows
        neg_s = family.neg_scores(side, rel_rows[0], ent_rows[2 * b:],
                                  neg_head, chunks, flags, *rel_rows[1:])
        loss = loss_of(pos, neg_s, flags)
        coef, p = flags["regularization_coef"], flags["regularization_norm"]
        if coef > 0 and p > 0:
            loss = loss + coef * (torch.sum(torch.abs(ent_rows) ** p)
                                  + torch.sum(torch.abs(rel_rows[0]) ** p))
        grads = torch.autograd.grad(loss, [ent_rows] + rel_rows)
    return loss.detach(), ent_ids, grads


def run(family, config: dict, triples: torch.Tensor, seed: int,
        marks, to_host=lambda x: x.clone()) -> dict:
    """The reference's first max(``marks``) steps (``triples`` [3, n] on
    the card): {"loss": [each step's], k: {"w": the tables, "s": their
    Adagrad states} after k steps for each k of ``marks``}, the tables in
    the family's order.  ``to_host`` keeps a snapshot (a clone by
    default)."""
    flags = config["flags"]
    dev = triples.device
    shapes = table_shapes(family, config)
    tables = init_tables(seed, shapes, dev)
    states = [torch.zeros(n, device=dev) for n, _, _ in shapes]
    b = flags["batch_size"]
    chunks = max(1, b // min(flags["neg_sample_size"], b))
    batches = Batches(seed, triples, b, chunks * flags["neg_sample_size"],
                      config["n_entities"])

    def snapshot():
        return {"w": [to_host(x) for x in tables],
                "s": [to_host(x) for x in states]}

    out = {"loss": []}
    if 0 in marks:
        out[0] = snapshot()
    for i in range(max(marks)):
        h, r, t, neg, neg_head = batches(i)
        loss, ent_ids, grads = step_loss_and_grads(
            family, flags, tables, h, r, t, neg, neg_head)
        ids = [ent_ids] + [r] * (len(tables) - 1)
        for table, state, at, g in zip(tables, states, ids, grads):
            adagrad(table, state, at, g, flags["lr"])
        del grads
        out["loss"].append(float(loss))
        if i + 1 in marks:
            out[i + 1] = snapshot()
    return out
