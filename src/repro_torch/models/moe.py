"""Mixture-of-Experts layer with paper-balanced dispatch.  Counterpart of
``repro/models/moe.py``.

Token->expert dispatch is the paper's 1-D partition problem: linearize
the assignment items by expert id (the "curve" order -- a stable sort),
compute each item's exclusive prefix sum of unit weights within its
expert run (Algorithm 1's S_i), and slice by expert capacity.  Items
whose prefix sum exceeds the capacity are dropped, like interval
overflow in the 1-D partitioner.

The dense strategy scatters into an (E, groups, C, d) buffer, runs
batched expert products and gathers back.  A group is one batch row: a
decode row, a full prefill's prompt, or the whole packed prefill buffer
(pad tokens included, as in the reference).  Without a model axis
``moe_apply`` takes it for any ``ep_shards`` (``_dense_expert_weights``
reads weights stored in the ``ep > E`` f-slice layout).

On a model axis (``model=``, the model group's ``Comm``; the experts on
"model", the router replicated) each rank holds a slice of the stored
expert rows, and the layer finds it from their shapes:

* ``ep_shards == 0`` (the launcher's case): rank i holds experts ``[i
  E/m, (i+1) E/m)``; it runs the dense strategy on the items routed to
  them (the dispatch, capacity ``capacity_factor s k / E`` a group
  included, is the one-rank dispatch), and the float32 partial outputs
  are summed over the group once, then rounded: ``_moe_dense``'s value
  up to summation order;
* ``ep_shards > 0`` is the reference's ``_moe_ep_shardmap``: rank r
  holds stored row r -- expert ``r // rpe``, or its f-slice ``r % rpe``
  when ``ep_shards > E`` -- runs the capacity dispatch of its expert,
  keeps its output in float32, and the ranks' outputs meet in one
  float32 sum, then the cast.

Either way the tokens and the gates enter a rank's part through
``layers.copy_to_model``: their gradients (the router's, through the
gates) are the sums of every rank's, while the aux loss, which every
rank computes alike from the replicated router, is not summed.

The auxiliary load-balancing loss (Switch-style f*P) is the
optimization-side counterpart of the paper's imbalance metric;
``dispatch_quality`` scores a routing decision with the paper's
imbalance itself.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from ..core.metrics import PartitionQuality
from ..core.metrics import quality as _partition_quality
from ..core.spec import BalanceSpec
from .config import ModelConfig
from .layers import (bmm_f32, copy_to_model, dense_param, kept, matmul_f32,
                     on_model_axis, reduce_from_model)

F32 = torch.float32


def dispatch_spec(cfg: ModelConfig) -> BalanceSpec:
    """The token->expert dispatch as a ``BalanceSpec``: items linearized
    by expert id ('linear' order), unit weights, one interval per expert
    -- the same declarative description the mesh and serving balancers
    resolve.  ``_dispatch_indices`` is its capacity-constrained form
    (slot = Algorithm 1's exclusive prefix sum within each interval)."""
    return BalanceSpec(p=cfg.n_experts, method="linear", oneD="sorted",
                       use_remap=False, padding="none")


def dispatch_quality(expert_idx: torch.Tensor, n_experts: int
                     ) -> PartitionQuality:
    """Expert-load quality of a routing decision via the shared core
    metrics: per-expert item counts and the paper's imbalance (max/mean).
    Use it to watch for routing collapse beside the aux loss."""
    flat = expert_idx.reshape(-1).long()
    return _partition_quality(flat, torch.ones(flat.shape, dtype=F32,
                                               device=flat.device),
                              n_experts)


def _ep_layout(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(ep, rpe, f_eff): ranks, ranks per expert, stored f width."""
    e, f = cfg.n_experts, cfg.d_ff
    ep = cfg.ep_shards
    if ep <= 0:
        return 0, 1, f
    if ep % e:
        raise ValueError(f"ep_shards={ep} is not a multiple of "
                         f"n_experts={e}")
    rpe = ep // e
    if f % rpe:
        raise ValueError(f"d_ff={f} does not split into {rpe} f-slices")
    return ep, rpe, f // rpe


def _expert_param(shape, dtype: torch.dtype, device, gen, scale: float
                  ) -> nn.Parameter:
    """Normal(0, scale) weights of ``shape`` (rows, ...) drawn in float32
    from ``gen`` one row at a time and cast to ``dtype``: the float32
    draw of a whole expert tensor would be a temporary of 6.4 GB at
    grok-1 width.  ``gen=None`` leaves them uninitialised, to be
    loaded."""
    w = torch.empty(shape, dtype=dtype, device=device)
    if gen is not None:
        for row in w:
            row.copy_(torch.randn(shape[1:], generator=gen, dtype=F32,
                                  device=device).mul_(scale))
    return kept(w)


class MoE(nn.Module):
    """The experts of one layer (the reference's ``init_moe``): a float32
    ``router`` (d, E); ``wi`` and ``wg`` (rows, d, f_eff) and ``wo``
    (rows, f_eff, d) in ``p_dtype``, rows = E (or ``ep_shards`` in the
    f-slice layout).  The expert weights take the reference's explicit
    scales, 1/sqrt(d) for ``wi`` and ``wg`` and 1/sqrt(d_ff) for ``wo``
    (``dense_param`` would take the leading dimension, E, as fan-in)."""

    def __init__(self, cfg: ModelConfig, device, gen=None):
        super().__init__()
        d, f, e = cfg.d_model, cfg.d_ff, cfg.n_experts
        ep, _, f_eff = _ep_layout(cfg)
        rows = ep if ep > 0 else e
        self.router = dense_param((d, e), F32, device, gen)
        self.wi = _expert_param((rows, d, f_eff), cfg.p_dtype, device, gen,
                                1.0 / math.sqrt(d))
        self.wg = _expert_param((rows, d, f_eff), cfg.p_dtype, device, gen,
                                1.0 / math.sqrt(d))
        self.wo = _expert_param((rows, f_eff, d), cfg.p_dtype, device, gen,
                                1.0 / math.sqrt(f))


def _dispatch_indices(expert_idx: torch.Tensor, n_experts: int,
                      capacity: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Paper Algorithm 1 applied to token->expert items, each group (the
    leading dimensions) on its own.

    expert_idx: (..., m) expert of each assignment item, token-major
    order.  Returns (slot, keep): slot (int32) = exclusive prefix sum of
    unit weights in expert-linearized order (position within the
    expert's capacity interval); keep = the item fits its interval."""
    m = expert_idx.shape[-1]
    dev = expert_idx.device
    order = torch.argsort(expert_idx, dim=-1, stable=True)
    sorted_e = torch.gather(expert_idx, -1, order).contiguous()
    experts = torch.arange(n_experts, dtype=sorted_e.dtype, device=dev)
    run_start = torch.searchsorted(
        sorted_e,
        experts.expand(*sorted_e.shape[:-1], n_experts).contiguous())
    pos_sorted = (torch.arange(m, device=dev)
                  - torch.gather(run_start, -1, sorted_e.long()))
    slot = torch.empty(order.shape, dtype=torch.int32, device=dev)
    slot.scatter_(-1, order, pos_sorted.to(torch.int32))
    return slot, slot < capacity


def _route(moe: MoE, x: torch.Tensor, cfg: ModelConfig, data=None,
           expert_idx: Optional[torch.Tensor] = None):
    """Router math: (gate_vals (b, s, k) float32, expert_idx (b, s, k),
    aux).  The top k come from a stable descending sort of the float32
    probabilities, so on a tie the lower expert id comes first, as
    ``jax.lax.top_k`` orders them (``torch.topk`` promises no order).
    A given ``expert_idx`` replaces the top k, with those experts' gates:
    another run's routing (``chip_smoke.py``'s oracle of an
    expert-parallel run takes that run's, so that a near-tie the two
    break apart in bf16 does not send a token to other experts).

    ``aux = e * sum_e f_e p_e`` over every token of the batch.  With a
    data group ``data``, ``x`` is this rank's rows of the global batch:
    ``f_e`` (which carries no gradient) comes from the expert counts and
    token count all-reduced over ``data``, and this rank's ``aux`` uses
    its own probability sums over the global token count, so the ranks'
    terms and their gradients sum to the global aux's."""
    b, s, _ = x.shape
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(matmul_f32(x.to(F32), moe.router), dim=-1)
    if expert_idx is None:
        expert_idx = torch.sort(probs, dim=-1, descending=True,
                                stable=True)[1][..., :k]
    gate_vals = torch.gather(probs, -1, expert_idx)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(dim=-1, keepdim=True),
                                        min=1e-9)
    # aux load-balance loss (the imbalance objective); the item counts
    # come from a sum of ones (exact in any order), since bincount would
    # read its input's maximum back to the host
    flat = expert_idx.reshape(-1)
    counts = torch.zeros(e, dtype=F32, device=x.device).index_add_(
        0, flat, torch.ones(flat.shape, dtype=F32, device=x.device))
    if data is None:
        f_e = counts / (b * s * k)
        p_e = probs.mean(dim=(0, 1))
    else:
        # the counts and this rank's token count, summed over the ranks
        # in one all-reduce (integers: exact in float32)
        tot = data.psum(torch.cat([counts, counts.new_full((1,), b * s)]))
        f_e = tot[:e] / (tot[e] * k)
        p_e = probs.sum(dim=(0, 1)) / tot[e]
    aux = e * torch.sum(f_e * p_e)
    return gate_vals, expert_idx, aux


def _dense_expert_weights(moe: MoE, cfg: ModelConfig):
    """Stored layout -> logical (E, d, f) / (E, f, d)."""
    e, f, d = cfg.n_experts, cfg.d_ff, cfg.d_model
    ep, rpe, f_eff = _ep_layout(cfg)
    wi, wg, wo = moe.wi, moe.wg, moe.wo
    if ep > 0 and rpe > 1:
        wi = wi.reshape(e, rpe, d, f_eff).permute(0, 2, 1, 3).reshape(e, d, f)
        wg = wg.reshape(e, rpe, d, f_eff).permute(0, 2, 1, 3).reshape(e, d, f)
        wo = wo.reshape(e, rpe, f_eff, d).reshape(e, f, d)
    return wi, wg, wo


def _moe_dense(moe: MoE, x: torch.Tensor, gate_vals: torch.Tensor,
               expert_idx: torch.Tensor, cfg: ModelConfig, model=None
               ) -> torch.Tensor:
    """Scatter each kept item into its expert's capacity slot, run every
    expert on its (groups x capacity) rows, gather back and weight by the
    gates.  The expert products sum in float32: ``h`` and ``g`` stay in
    float32 through the activation and are rounded once to ``act_dtype``,
    and so is each expert's output, as the reference's einsums with
    ``preferred_element_type=float32`` do.  A dropped item adds an exact
    0 at ``min(slot, capacity - 1)`` and gathers 0.

    With ``model`` (the model group), ``moe`` holds this rank's block of
    the experts: the items routed elsewhere add and gather 0 here, and
    the float32 sums over k are summed over the group, then rounded."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    act, dev = cfg.act_dtype, x.device
    capacity = max(int(cfg.capacity_factor * s * k / e), 1)
    wi, wg, wo = _dense_expert_weights(moe, cfg)
    el = wi.shape[0]
    first = 0 if model is None else model.rank * el

    flat_e = expert_idx.reshape(b, s * k).long()
    slot, keep = _dispatch_indices(flat_e, e, capacity)
    slot = torch.clamp(slot, max=capacity - 1).long()
    mine = keep & (flat_e >= first) & (flat_e < first + el)
    local_e = torch.where(mine, flat_e - first, 0)
    group = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    token_of_item = torch.arange(s * k, device=dev) // k
    contrib = torch.where(mine[..., None], x[:, token_of_item], 0.0)
    # expert-major, so that each expert's rows are one contiguous block
    x_disp = torch.zeros((el, b, capacity, d), dtype=act, device=dev)
    x_disp.index_put_((local_e, group, slot), contrib.to(act),
                      accumulate=True)

    xe = x_disp.reshape(el, b * capacity, d)
    h = torch.nn.functional.silu(bmm_f32(xe, wg)) * bmm_f32(xe, wi)
    y_e = bmm_f32(h.to(act), wo).to(act).reshape(el, b, capacity, d)

    gathered = torch.where(mine[..., None], y_e[local_e, group, slot], 0.0)
    gathered = gathered * gate_vals.reshape(b, s * k)[..., None]
    out = gathered.reshape(b, s, k, d).sum(dim=2)
    if model is not None:
        out = reduce_from_model(out, model)
    return out.to(act)


def _moe_ep(moe: MoE, x: torch.Tensor, gate_vals: torch.Tensor,
            expert_idx: torch.Tensor, cfg: ModelConfig, model
            ) -> torch.Tensor:
    """The reference's ``_moe_ep_shardmap`` on model rank r, which holds
    stored row r of ``ep_shards``: expert ``r // rpe`` (its f-slice ``r %
    rpe``).  The items routed to that expert and kept by the capacity
    dispatch run through it; its output stays float32 through the gates
    and the sum over k, and the ranks' outputs are summed once in
    float32 (the f-slices' partial products with them), then cast."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    _, rpe, _ = _ep_layout(cfg)
    act, dev = cfg.act_dtype, x.device
    capacity = max(int(cfg.capacity_factor * s * k / e), 1)
    if moe.wi.shape[0] != 1:
        raise ValueError(f"ep_shards={cfg.ep_shards} over {model.size} model "
                         "ranks: the expert-parallel branch holds one stored "
                         "row a rank")
    flat_e = expert_idx.reshape(b, s * k).long()
    slot, keep = _dispatch_indices(flat_e, e, capacity)
    slot = torch.clamp(slot, max=capacity - 1).long()
    mine = keep & (flat_e == model.rank // rpe)
    group = torch.arange(b, device=dev)[:, None].expand(b, s * k)
    token_of_item = torch.arange(s * k, device=dev) // k
    contrib = torch.where(mine[..., None], x[:, token_of_item], 0.0)
    x_disp = torch.zeros((b, capacity, d), dtype=act, device=dev)
    x_disp.index_put_((group, slot), contrib.to(act), accumulate=True)

    h = torch.nn.functional.silu(matmul_f32(x_disp, moe.wg[0])) \
        * matmul_f32(x_disp, moe.wi[0])
    y_e = matmul_f32(h.to(act), moe.wo[0])               # float32

    gathered = torch.where(mine[..., None], y_e[group, slot], 0.0)
    gathered = gathered * gate_vals.reshape(b, s * k)[..., None]
    part = gathered.reshape(b, s, k, d).sum(dim=2)
    return reduce_from_model(part, model).to(act)


def moe_apply(moe: MoE, x: torch.Tensor, cfg: ModelConfig, *, data=None,
              model=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (b, s, d) -> (out, aux_loss).  Groups = batch rows (capacity is
    per row, so splitting a batch by rows over ``data`` changes no
    dispatch); ``data``: this rank's term of the aux (``_route``).  With
    the expert rows this rank's slice (``model``, the model group), the
    expert-parallel strategies of the module docstring."""
    gate_vals, expert_idx, aux = _route(moe, x, cfg, data)
    ep, _, _ = _ep_layout(cfg)
    if not on_model_axis(moe.wi.shape[0], ep or cfg.n_experts, model):
        return _moe_dense(moe, x, gate_vals, expert_idx, cfg), aux
    x, gate_vals = copy_to_model(x, model), copy_to_model(gate_vals, model)
    if ep > 0:
        return _moe_ep(moe, x, gate_vals, expert_idx, cfg, model), aux
    return _moe_dense(moe, x, gate_vals, expert_idx, cfg, model), aux
