"""TransE_l2's training loss and its gradients with respect to the gathered
rows as one fused pass: PyTorch's own sums where the result depends on
their order, the CUDA kernels of ``csrc/transe_l2.cu`` for the rest, and
their plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves the score and the loss to
XLA's fusion.  In the port they were autograd over some eighty PyTorch
launches a step (``TransEScore.pos_score`` / ``neg_score``,
``batched_l2_dist``, ``LossGenerator.get_total_loss``, ``regularization``
and the backward of each).  The source's note says what bounds the kernels
on the card and what their design does about it.

What it computes is the autograd route's mathematics in fp32, for the
pointwise Logsigmoid loss: the positives by the direct difference, each
chunk's queries (h + r tail-corrupt, t - r head-corrupt) against its K
shared negatives by dgl-ke's expansion |q|^2 + |n|^2 - 2 q.n clamped at
1e-30 before the square root, the self-adversarial weights held constant,
per-edge weights, this rank's share of the batch, and coef * sum |x|^p
over every gathered row.  The log values are summed in fp64 and rounded
once.

A call on the card: q = h + r (or t - r), |q|^2, |n|^2 and q.n by the
PyTorch calls autograd's forward makes (``_score_sums``), the row pass
(kernel), the sums of dloss/dsq over each row and each column by
PyTorch's sum, the gradient pass (kernel).  Those four sums are shared by
every element of a row's gradient, so their order moves the tables'
gradient norms by 1e-9 to 6e-9 of themselves, which kgbench's check reads
(csrc/transe_l2.cu says how that was measured); everything else may round
in its own order.  The wrapper takes the plain version only for CPU
tensors; on the card it launches the kernels (two launches a call,
counted in ``rows.launches["transe_l2_loss"]``) or raises.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from dglke_tpu_torch.ops import rows
from dglke_tpu_torch.ops.outer_update import reg_grad

SOURCE = rows.CSRC / "transe_l2.cu"
_P, _I64, _INT, _F = (ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
                      ctypes.c_float)


class _Args(ctypes.Structure):
    """csrc/transe_l2.cu's DglkeTranseL2: one call's arguments."""
    _fields_ = ([(n, _P) for n in ("ent", "rel", "weights", "q", "q_sq",
                                   "n_sq", "dot", "row_sum", "col_sum", "s",
                                   "cpos", "partials")]
                + [("slots", _I64)]
                + [(n, _P) for n in ("ent_grad", "rel_grad", "out")]
                + [(n, _I64) for n in ("b", "chunks", "bc", "k", "dim")]
                + [(n, _INT) for n in ("neg_head", "adv", "reg_pow")]
                + [(n, _F) for n in ("gamma", "temp", "scale", "share",
                                     "coef")])


SIGNATURES = {
    "dglke_transe_l2_rows": ([ctypes.POINTER(_Args), _P], _INT),
    "dglke_transe_l2_grads": ([ctypes.POINTER(_Args), _P], _INT),
}
LAUNCHES = 2          # kernels a call: the row pass, the gradient pass
LOG_KEYS = ("pos_loss", "neg_loss", "loss", "regularization")
_ROWS_PER_BLOCK = 8   # rows of the row pass a block (kRowsPerBlock)
_LOGS = 3             # fp64 partials a block of the row pass


def fits(ent_rows: torch.Tensor, rel_rows: torch.Tensor, *, b: int,
         num_chunks: int, chunk_size: int, neg_sample_size: int) -> bool:
    """Whether the fused route takes these rows: fp32 [2b + C K, D] entity
    rows and [b, D] relation rows on one device, b = C chunks of
    chunk_size positives.  The same on the CPU and on the card: the
    kernels take any D and K (16-byte loads where both are multiples of
    four on aligned rows, element loads otherwise) and any strides (the
    wrapper makes the rows contiguous)."""
    c, bc, k = num_chunks, chunk_size, neg_sample_size
    if ent_rows.dim() != 2 or rel_rows.dim() != 2:
        return False
    d = rel_rows.shape[1]
    return (ent_rows.dtype == rel_rows.dtype == torch.float32
            and ent_rows.device == rel_rows.device
            and min(b, c, bc, k, d) > 0 and b == c * bc
            and tuple(ent_rows.shape) == (2 * b + c * k, d)
            and tuple(rel_rows.shape) == (b, d))


def _row_blocks(b: int, n_neg: int, reg: bool) -> int:
    """Blocks of the row pass: the positives', then with regularization
    the negative rows'."""
    return -(-b // _ROWS_PER_BLOCK) + (-(-n_neg // _ROWS_PER_BLOCK)
                                       if reg else 0)


def _logsigmoid_deriv(x: torch.Tensor) -> torch.Tensor:
    """d logsigmoid(x) / dx as PyTorch's log_sigmoid_backward forms it."""
    z = torch.exp(-torch.abs(x))
    t = z / (1.0 + z)
    return torch.where(x < 0, 1.0 - t, t)


def _scale(b: int, share: float) -> float:
    """share / (2 b) in fp32, as autograd forms the mean's gradient."""
    return float(np.float32(share) * (np.float32(0.5) / np.float32(b)))


def _score_sums(ent_rows, rel_rows, *, b, num_chunks, chunk_size,
                neg_sample_size, neg_head):
    """q [C, Bc, D], |q|^2 [C, Bc], |n|^2 [C, K] and q.n [C, Bc, K] by the
    PyTorch calls of autograd's forward (models/score_functions.py:
    batched_l2_dist), so that they round as its do."""
    d = rel_rows.shape[1]
    side = ent_rows[b:2 * b] if neg_head else ent_rows[:b]
    q = ((side - rel_rows) if neg_head else (side + rel_rows)).reshape(
        num_chunks, chunk_size, d)
    n = ent_rows[2 * b:].reshape(num_chunks, neg_sample_size, d)
    return (q, torch.sum(q * q, dim=-1), torch.sum(n * n, dim=-1),
            torch.matmul(q, n.transpose(-1, -2)))


def _grad_sums(s):
    """sum_k s_ik [C, Bc, 1] and sum_i s_ik [C, 1, K], as autograd sums the
    gradient of a broadcast."""
    return s.sum(dim=2, keepdim=True), s.sum(dim=1, keepdim=True)


def loss_and_grads_plain(ent_rows, rel_rows, weights, *, b, num_chunks,
                         chunk_size, neg_sample_size, neg_head, gamma,
                         adversarial, temperature, share, reg_coef, reg_pow):
    """The kernels' arithmetic in PyTorch (see loss_and_grads)."""
    c, bc, k = num_chunks, chunk_size, neg_sample_size
    d = rel_rows.shape[1]
    h, t, n = ent_rows[:b], ent_rows[b:2 * b], ent_rows[2 * b:]
    r = rel_rows
    w = (torch.ones(b, dtype=torch.float32, device=ent_rows.device)
         if weights is None else weights.to(torch.float32))
    scale = _scale(b, share)
    # positives: gamma - |h + r - t|, and dloss/de = cpos * e
    e = (h + r) - t
    pnorm = torch.sqrt(torch.sum(e * e, dim=-1) + 1e-30)
    pos = gamma - pnorm
    pos_terms = -F.logsigmoid(pos) * w
    cpos = scale * w * _logsigmoid_deriv(pos) / pnorm
    # each chunk's queries against its K negatives, by the expansion
    q, q_sq, n_sq, dot = _score_sums(
        ent_rows, rel_rows, b=b, num_chunks=c, chunk_size=bc,
        neg_sample_size=k, neg_head=neg_head)
    nc = n.reshape(c, k, d)
    sq = (q_sq[:, :, None] + n_sq[:, None, :]) - 2.0 * dot
    dist = torch.sqrt(torch.clamp(sq, min=1e-30))
    neg = gamma - dist
    wc = w.reshape(c, bc, 1)
    terms = -F.logsigmoid(-neg) * wc
    if adversarial:
        a = torch.softmax(neg * temperature, dim=-1)
        neg_terms = torch.sum(a * terms, dim=-1)
    else:
        a = 1.0 / k
        neg_terms = torch.sum(terms, dim=-1) / k
    # s = dloss/dsq, 0 where the clamp holds sq
    dneg = (scale * wc * a) * _logsigmoid_deriv(-neg)
    s = torch.where(sq >= 1e-30, -dneg / (2.0 * dist), torch.zeros_like(dist))
    row_sum, col_sum = _grad_sums(s)
    g_q = (2.0 * (row_sum * q) - 2.0 * torch.bmm(s, nc)).reshape(b, d)
    g_n = (2.0 * (col_sum.transpose(1, 2) * nc)
           - 2.0 * torch.bmm(s.transpose(1, 2), q))
    pe = cpos[:, None] * e
    if neg_head:       # q = t - r
        gh, gt, gr = pe, g_q - pe, pe - g_q
    else:              # q = h + r
        gh, gt, gr = pe + g_q, -pe, pe + g_q
    ent_grads = torch.cat([gh, gt, g_n.reshape(c * k, d)])
    rel_grads = gr
    pos_loss = (pos_terms.double().sum() / b).float()
    neg_loss = (neg_terms.double().sum() / b).float()
    loss = (pos_loss + neg_loss) / 2.0 * share
    log = {"pos_loss": pos_loss * share, "neg_loss": neg_loss * share,
           "loss": loss}
    if reg_pow:
        total = sum((torch.abs(x) ** reg_pow).double().sum()
                    for x in (ent_rows, rel_rows)).float()
        log["regularization"] = reg_coef * total
        loss = loss + log["regularization"]
        ent_grads = ent_grads + reg_grad(ent_rows, reg_coef, reg_pow)
        rel_grads = rel_grads + reg_grad(rel_rows, reg_coef, reg_pow)
    return loss, log, ent_grads, rel_grads


def launch(ent_rows, rel_rows, weights, *, b, num_chunks, chunk_size,
           neg_sample_size, neg_head, gamma, adversarial, temperature, share,
           reg_coef, reg_pow):
    """The PyTorch sums and the two kernels on CUDA tensors (checked by the
    caller); counts LAUNCHES launches of transe_l2_loss.  The log values
    are views of one output tensor.  Raises where a launch refuses its
    arguments (a grid past 2^31 - 1 blocks)."""
    dev = ent_rows.device
    ent_rows, rel_rows = ent_rows.contiguous(), rel_rows.contiguous()
    c, bc, k = num_chunks, chunk_size, neg_sample_size
    w = None if weights is None else weights.to(torch.float32).contiguous()
    if w is not None and (w.shape != (b,) or w.device != dev):
        raise ValueError(f"transe_l2_loss: edge weights {tuple(w.shape)} on "
                         f"{w.device}, want [{b}] on {dev}")
    q, q_sq, n_sq, dot = _score_sums(
        ent_rows, rel_rows, b=b, num_chunks=c, chunk_size=bc,
        neg_sample_size=k, neg_head=neg_head)
    s = torch.empty_like(dot)
    cpos = torch.empty(b, dtype=torch.float32, device=dev)
    partials = torch.empty(_row_blocks(b, c * k, bool(reg_pow)) * _LOGS,
                           dtype=torch.float64, device=dev)
    ent_grad = torch.empty_like(ent_rows)
    rel_grad = torch.empty_like(rel_rows)
    out = torch.empty(5, dtype=torch.float32, device=dev)
    args = _Args(
        ent_rows.data_ptr(), rel_rows.data_ptr(),
        None if w is None else w.data_ptr(),
        q.data_ptr(), q_sq.data_ptr(), n_sq.data_ptr(), dot.data_ptr(),
        None, None, s.data_ptr(), cpos.data_ptr(), partials.data_ptr(),
        partials.numel(), ent_grad.data_ptr(), rel_grad.data_ptr(),
        out.data_ptr(), b, c, bc, k, rel_rows.shape[1], int(neg_head),
        int(adversarial), int(reg_pow), float(gamma), float(temperature),
        _scale(b, share), float(share), float(reg_coef))
    lib = rows.load_library(SOURCE, SIGNATURES)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rows.check_launch(lib.dglke_transe_l2_rows(ctypes.byref(args),
                                                   stream), "transe_l2_rows")
        row_sum, col_sum = _grad_sums(s)
        args.row_sum, args.col_sum = row_sum.data_ptr(), col_sum.data_ptr()
        rows.check_launch(lib.dglke_transe_l2_grads(ctypes.byref(args),
                                                    stream),
                          "transe_l2_grads")
    rows.launches["transe_l2_loss"] += LAUNCHES
    log = dict(zip(LOG_KEYS, out[:4] if reg_pow else out[:3]))
    return out[4], log, ent_grad, rel_grad


def loss_and_grads(ent_rows: torch.Tensor, rel_rows: torch.Tensor, weights,
                   *, b: int, num_chunks: int, chunk_size: int,
                   neg_sample_size: int, neg_head: bool, gamma: float,
                   adversarial: bool, temperature: float, share: float,
                   reg_coef: float, reg_pow: int):
    """TransE_l2's Logsigmoid loss and its gradients w.r.t. the gathered
    rows: ent_rows [h (b) | t (b) | negatives (C K)] and rel_rows [b], both
    fp32 (``fits``); weights: per-edge weights [b] or None; neg_head: the
    chunks corrupt heads; adversarial: the self-adversarial weights at
    ``temperature``; share: this rank's share of the global batch (1 on
    one device), scaling the loss, its log values and the gradients;
    reg_pow: 0 without regularization, else the norm whose
    reg_coef * sum |x|^p is added over every row.

    Returns (loss with the regularization, the log {pos_loss, neg_loss,
    loss, [regularization]} as 0-d tensors, ent_grads, rel_grads shaped
    as the rows)."""
    chunks = dict(b=b, num_chunks=num_chunks, chunk_size=chunk_size,
                  neg_sample_size=neg_sample_size)
    if not fits(ent_rows, rel_rows, **chunks):
        raise ValueError(
            f"transe_l2_loss: rows {ent_rows.dtype} {tuple(ent_rows.shape)} "
            f"and {rel_rows.dtype} {tuple(rel_rows.shape)} do not fit "
            f"{chunks}")
    args = dict(chunks, neg_head=neg_head, gamma=gamma,
                adversarial=adversarial, temperature=temperature,
                share=share, reg_coef=reg_coef, reg_pow=reg_pow)
    if ent_rows.device.type == "cpu":
        return loss_and_grads_plain(ent_rows, rel_rows, weights, **args)
    return launch(ent_rows, rel_rows, weights, **args)
