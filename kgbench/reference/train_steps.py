"""The first training steps of a cell, in plain PyTorch, from the seed.

Each step follows dgl-ke's recipe as the configuration states it: gather
the rows of [h | t | negatives] and of the relations, score the positives
and each chunk's shared negatives, take the self-adversarial Logsigmoid
loss plus ``regularization_coef`` x the sum of |row|^p over the gathered
rows, differentiate with respect to the gathered rows, and write both
tables back through row-sparse Adagrad (state += mean(g^2) per
occurrence, then row -= lr g / (sqrt(state) + 1e-10)).  Returns every
step's loss and the tables with their Adagrad states after each step count
the check reads."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from kgbench.reference.streams import Batches, init_tables


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


def step_loss_and_grads(family, flags, ent, rel, h, r, t, neg, neg_head):
    """(loss, entity ids, entity row grads, relation row grads)."""
    b = h.shape[0]
    chunks = max(1, b // min(flags["neg_sample_size"], b))
    ent_ids = torch.cat([h, t, neg.long()])
    ent_rows = ent[ent_ids].detach().requires_grad_()
    rel_rows = rel[r].detach().requires_grad_()
    with torch.enable_grad():
        h_rows, t_rows = ent_rows[:b], ent_rows[b:2 * b]
        pos = family.pos_score(h_rows, rel_rows, t_rows, flags)
        side = t_rows if neg_head else h_rows
        neg_s = family.neg_scores(side, rel_rows, ent_rows[2 * b:], neg_head,
                                  chunks, flags)
        loss = loss_of(pos, neg_s, flags)
        coef, p = flags["regularization_coef"], flags["regularization_norm"]
        if coef > 0 and p > 0:
            loss = loss + coef * (torch.sum(torch.abs(ent_rows) ** p)
                                  + torch.sum(torch.abs(rel_rows) ** p))
        g_ent, g_rel = torch.autograd.grad(loss, (ent_rows, rel_rows))
    return loss.detach(), ent_ids, g_ent, g_rel


def run(family, config: dict, triples: torch.Tensor, seed: int,
        marks, to_host=lambda x: x.clone()) -> dict:
    """The reference's first max(``marks``) steps (``triples`` [3, n] on
    the card): {"loss": [each step's], k: {"w": [entity, relation],
    "s": [their Adagrad states]} after k steps for each k of ``marks``}.
    ``to_host`` keeps a snapshot (a clone by default)."""
    flags = config["flags"]
    dev = triples.device
    hidden = flags["hidden_dim"]
    ent_w, rel_w = family.widths(hidden)
    emb_init = (flags["gamma"] + 2.0) / hidden
    ent, rel = init_tables(seed, [(config["n_entities"], ent_w),
                                  (config["n_relations"], rel_w)],
                           emb_init, dev)
    s_ent = torch.zeros(ent.shape[0], device=dev)
    s_rel = torch.zeros(rel.shape[0], device=dev)
    b = flags["batch_size"]
    chunks = max(1, b // min(flags["neg_sample_size"], b))
    batches = Batches(seed, triples, b, chunks * flags["neg_sample_size"],
                      config["n_entities"])

    def snapshot():
        return {"w": [to_host(ent), to_host(rel)],
                "s": [to_host(s_ent), to_host(s_rel)]}

    out = {"loss": []}
    if 0 in marks:
        out[0] = snapshot()
    for i in range(max(marks)):
        h, r, t, neg, neg_head = batches(i)
        loss, ent_ids, g_ent, g_rel = step_loss_and_grads(
            family, flags, ent, rel, h, r, t, neg, neg_head)
        adagrad(ent, s_ent, ent_ids, g_ent, flags["lr"])
        adagrad(rel, s_rel, r, g_rel, flags["lr"])
        del g_ent, g_rel
        out["loss"].append(float(loss))
        if i + 1 in marks:
            out[i + 1] = snapshot()
    return out
