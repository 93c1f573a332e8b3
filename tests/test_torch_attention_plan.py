"""The bf16 attention kernels' launch plan and their arithmetic, on the CPU.

The wgmma kernels (csrc/attention_wgmma.cuh) run only on a card, so what
can be read here is read here: the launch plan the wrappers hand them
(``flash_attention.attention_plan``: padded head dim, query rows a CTA,
key tile, ring depth, shared memory, the padding rule), and a plain-torch
emulation of the kernels' arithmetic (bf16 Q K^T summed in float32, a
tile-wise online softmax in base 2 over the plan's key tiles, P split
into its top 16 bits and the bf16 rounding of the remainder for P V),
held against the JAX package's Pallas kernels in interpret mode and its
plain attention.

Tolerance: both sides round the output to bf16 once from float32 sums
taken in other orders, so an element may differ by one bf16 step (2**-7
of its value) plus 1e-3 near 0, the limit the card tests and
chip_smoke.py hold the kernels to.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.serve_prefill import packed_attention_pallas
from repro.models.layers import _chunked_attention
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.kernels.flash_attention import (PACKED_TILES, SMEM_LIMIT,
                                                 TILES, attention_plan,
                                                 pad_head_dim,
                                                 padded_head_dim)

LOG2E = np.float32(1.4426950408889634)
RTOL, ATOL = 2.0 ** -7, 1e-3


# --- the launch plan ---------------------------------------------------------

@pytest.mark.parametrize("d,dp", [(1, 64), (8, 64), (16, 64), (48, 64),
                                  (64, 64), (65, 128), (80, 128), (100, 128),
                                  (120, 128), (128, 128), (129, 256),
                                  (196, 256), (200, 256), (256, 256)])
def test_plan_pads_the_head_dim_to_64_128_or_256(d, dp):
    assert padded_head_dim(d) == dp
    assert attention_plan(d, 1024).dp == dp


@pytest.mark.parametrize("d", [0, 257])
def test_plan_refuses_head_dims_past_the_kernels(d):
    with pytest.raises(ValueError, match="head dim"):
        attention_plan(d, 128)


@pytest.mark.parametrize("s_q,rows", [(1, 64), (128, 64), (129, 64),
                                      (1024, 64), (2047, 64), (2048, 128),
                                      (6144, 128), (32768, 128)])
@pytest.mark.parametrize("d", [80, 120, 128])
def test_plan_rows_a_cta(d, s_q, rows):
    """Flash takes 128 query rows (two consumer warpgroups) from 2,048
    rows on at padded head dim 128, else 64; the packed kernel always 64."""
    assert attention_plan(d, s_q).rows == rows
    assert attention_plan(d, s_q, packed=True, buffer=s_q).rows == 64


@pytest.mark.parametrize("d", [16, 64, 200, 256])
@pytest.mark.parametrize("s_q", [1, 1500, 32768])
def test_plan_rows_64_at_head_dims_64_and_256(d, s_q):
    assert attention_plan(d, s_q).rows == 64


@pytest.mark.parametrize("d", [8, 16, 48, 64, 72, 80, 120, 128, 200, 256])
def test_plan_runs_multiples_of_8_unpadded(d):
    plan = attention_plan(d, 300)
    assert not plan.padded and plan.d_kernel == d


@pytest.mark.parametrize("d", [1, 7, 33, 100, 130, 196, 255])
def test_plan_pads_other_head_dims_to_the_kernels(d):
    """TMA reads rows of a multiple of 16 bytes: other head dims are
    copied into zero-padded tensors of the kernel's head dim."""
    plan = attention_plan(d, 300)
    assert plan.padded and plan.d_kernel == plan.dp == padded_head_dim(d)


def test_plan_pads_misaligned_inputs():
    plan = attention_plan(128, 300, aligned=False)
    assert plan.padded and plan.d_kernel == 128 and plan.d == 128
    plan = attention_plan(64, 300, packed=True, aligned=False, buffer=300)
    assert plan.padded


@pytest.mark.parametrize("dp", [64, 128, 256])
@pytest.mark.parametrize("s_q", [64, 1024, 4096])
def test_plan_shared_memory_fits_a_block(dp, s_q):
    plan = attention_plan(dp, s_q)
    bk, stages = TILES[dp, plan.rows]
    want = (1024 + plan.rows * dp * 2 + 2 * stages * bk * dp * 2
            + 8 * (2 * stages + 1))
    assert plan.smem_bytes == want <= SMEM_LIMIT
    assert (plan.bk, plan.stages) == (bk, stages)
    assert 2 <= stages <= 4 and bk % 16 == 0
    # every tile a whole number of 1,024-byte swizzle atoms
    assert (bk * 128) % 1024 == 0 and (plan.rows * 128) % 1024 == 0


@pytest.mark.parametrize("dp,rows,ctas", [(64, 64, 3), (128, 64, 2),
                                          (128, 128, 1), (256, 64, 1)])
def test_plan_ctas_an_sm(dp, rows, ctas):
    """One-group CTAs below DP = 256 leave shared memory for two or three
    CTAs an SM (228 KB, 1 KB reserved a CTA); the rest take one."""
    bk, stages = TILES[dp, rows]
    smem = (1024 + rows * dp * 2 + 2 * stages * bk * dp * 2
            + 8 * (2 * stages + 1))
    assert (228 * 1024) // (smem + 1024) >= ctas


@pytest.mark.parametrize("dp", sorted(PACKED_TILES))
@pytest.mark.parametrize("C", [64, 2048, 8192])
def test_plan_packed_fits_two_ctas_an_sm(dp, C):
    """The packed kernel's ring leaves room for two CTAs an SM (228 KB
    of shared memory, 1 KB reserved a CTA) at the engine's buffers."""
    plan = attention_plan(dp, C, packed=True, buffer=C)
    bk, stages = PACKED_TILES[dp]
    base = (1024 + 64 * dp * 2 + 2 * stages * bk * dp * 2
            + 8 * (2 * stages + 1))
    assert (plan.bk, plan.stages, plan.rows) == (bk, stages, 64)
    assert plan.smem_bytes == base + 12 * -(-C // 64) <= SMEM_LIMIT
    if C <= 2048:
        assert 2 * (plan.smem_bytes + 1024) <= 228 * 1024


def test_plan_packed_refuses_head_dims_past_128():
    with pytest.raises(ValueError, match="128"):
        attention_plan(200, 2048, packed=True, buffer=2048)


# every configuration that runs attention (mamba2 runs none)
ATTENTION_ARCHS = [a for a in ARCH_IDS if get_config(a).family != "ssm"]


@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_every_config_head_dim_runs_unpadded(arch):
    """The configurations' attention head dims (64, 80, 120, 128 and 256)
    go to the kernels as they are, with no padding copy."""
    cfg = get_config(arch)
    plan = attention_plan(cfg.hd, 4096)
    assert not plan.padded and (plan.dp, plan.rows) in TILES
    assert cfg.hd in (64, 80, 120, 128, 256)


def test_pad_head_dim_adds_zero_columns():
    x = torch.randn(2, 3, 5, 100).bfloat16()
    (p,) = pad_head_dim((x,), 128)
    assert p.shape == (2, 3, 5, 128) and p.is_contiguous()
    assert torch.equal(p[..., :100], x) and not p[..., 100:].any()


# --- the kernels' arithmetic -------------------------------------------------

def wgmma_emulation(q, k, v, visible, *, scale, bk, softcap=None):
    """The wgmma body's arithmetic in plain torch: q (h, s_q, d), k / v
    (h, s_kv, d) bf16 with matched heads, visible (s_q, s_kv) bool.
    Scores in log2 units (the scale, or the soft cap, folded with log2 e
    in float32), an online softmax over key tiles of ``bk``, P V as the
    product of P truncated to bf16 (its top 16 bits) plus that of the
    remainder rounded to bf16; a row that sees no key is 0.  Returns
    bf16."""
    qf, kf, vf = q.float(), k.float(), v.float()
    h, s_q, d = q.shape
    s_kv = k.shape[1]
    m = torch.full((h, s_q), -math.inf)
    l = torch.zeros((h, s_q))
    o = torch.zeros((h, s_q, d))
    if softcap:
        cap_log2 = float(np.float32(softcap) * LOG2E)
        over = float(np.float32(scale) / np.float32(softcap))
    else:
        scale_log2 = float(np.float32(scale) * LOG2E)
    for j0 in range(0, s_kv, bk):
        s = qf @ kf[:, j0:j0 + bk].transpose(1, 2)
        x = cap_log2 * torch.tanh(s * over) if softcap else s * scale_log2
        x = x.masked_fill(~visible[:, j0:j0 + bk], -math.inf)
        m_new = torch.maximum(m, x.amax(-1))
        m_use = torch.where(m_new == -math.inf, 0.0, m_new)
        alpha = torch.exp2(m - m_use)
        p = torch.exp2(x - m_use[..., None])
        l = l * alpha + p.sum(-1)
        hi = (p.view(torch.int32) & -65536).view(torch.float32)
        lo = (p - hi).bfloat16().float()
        vt = vf[:, j0:j0 + bk]
        o = o * alpha[..., None] + hi @ vt + lo @ vt
        m = m_new
    inv = torch.where(l > 0, 1.0 / l, 0.0)
    return (o * inv[..., None]).bfloat16()


def _inputs(rng, b, hq, hkv, s_q, s_kv, d):
    """bf16 q, k, v as torch tensors and as the same values for JAX."""
    shapes = ((b, hq, s_q, d), (b, hkv, s_kv, d), (b, hkv, s_kv, d))
    ts = [torch.as_tensor(rng.standard_normal(sh).astype(np.float32))
          .bfloat16() for sh in shapes]
    js = [jnp.asarray(t.float().numpy(), dtype=jnp.bfloat16) for t in ts]
    return ts, js


def _flash_emulated(q, k, v, *, causal, window, s_q, s_kv):
    b, hq, _, d = q.shape
    group = hq // k.shape[1]
    i = torch.arange(s_q)[:, None]
    j = torch.arange(s_kv)[None, :]
    vis = torch.ones((s_q, s_kv), dtype=torch.bool)
    if causal:
        vis &= j <= i
    if window is not None:
        vis &= j > i - window
    bk = attention_plan(d, s_q).bk
    out = [wgmma_emulation(q[bi], k[bi].repeat_interleave(group, 0),
                           v[bi].repeat_interleave(group, 0), vis,
                           scale=1.0 / math.sqrt(d), bk=bk)
           for bi in range(b)]
    return torch.stack(out)


def _assert_close(got, want):
    got = got.float()
    want = torch.as_tensor(np.asarray(want, dtype=np.float32))
    diff = (got - want).abs()
    limit = RTOL * want.abs() + ATOL
    assert bool((diff <= limit).all()), float((diff / limit).max())


@pytest.mark.parametrize("d", [64, 80, 120, 128, 256])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 96),
                                           (False, None)])
def test_emulation_matches_flash_pallas(d, causal, window):
    """s = 256 (two of the Pallas kernel's 128-row blocks), GQA 4 / 2."""
    rng = np.random.default_rng(d + (window or 0))
    (q, k, v), (jq, jk, jv) = _inputs(rng, 1, 4, 2, 256, 256, d)
    want = flash_attention_pallas(jq, jk, jv, causal=causal, window=window,
                                  interpret=True)
    got = _flash_emulated(q, k, v, causal=causal, window=window, s_q=256,
                          s_kv=256)
    _assert_close(got, want)


@pytest.mark.parametrize("d", [64, 80, 120, 128, 256])
@pytest.mark.parametrize("s,window", [(77, None), (200, 64), (129, None)])
def test_emulation_matches_plain_attention_ragged(d, s, window):
    """Lengths that are no multiple of the key tile (nor of the Pallas
    kernel's block) against the JAX package's plain attention."""
    rng = np.random.default_rng(s * 7 + d)
    (q, k, v), (jq, jk, jv) = _inputs(rng, 2, 2, 1, s, s, d)
    want = jref.mha_ref(jq, jk, jv, causal=True, window=window)
    got = _flash_emulated(q, k, v, causal=True, window=window, s_q=s,
                          s_kv=s)
    _assert_close(got, want)


@pytest.mark.parametrize("d", [64, 80, 120, 128, 256])
@pytest.mark.parametrize("s_q,s_kv", [(1, 150), (65, 129), (130, 70)])
def test_emulation_matches_cross_attention(d, s_q, s_kv):
    """K/V of another length than Q, no mask, against the JAX package's
    chunked attention (the encoder-decoder's cross-attention)."""
    rng = np.random.default_rng(s_q * 3 + s_kv + d)
    (q, k, v), (jq, jk, jv) = _inputs(rng, 1, 4, 4, s_q, s_kv, d)
    want = _chunked_attention(jq, jk, jv, causal=False, window=None,
                              chunk=s_kv)
    got = _flash_emulated(q, k, v, causal=False, window=None, s_q=s_q,
                          s_kv=s_kv)
    _assert_close(got, want)


def _pack(C, lengths, gap):
    seg = np.full(C, -1, np.int32)
    off = 0
    for sid, n in enumerate(lengths):
        seg[off:off + n] = sid
        off += n + gap
    return seg


@pytest.mark.parametrize("d", [64, 80, 120, 128])
@pytest.mark.parametrize("lengths,gap,softcap", [
    ((100, 60, 40), 4, 30.0),           # soft cap, a request past a tile
    ((130, 3, 64), 0, None),            # one request across 128 rows
    ((1, 70), 9, 5.0),                  # pad gaps, a one-token request
])
def test_emulation_matches_packed_pallas(d, lengths, gap, softcap):
    C, hq, hkv = 256, 4, 2
    rng = np.random.default_rng(d + sum(lengths))
    (q, k, v), (jq, jk, jv) = _inputs(rng, 1, hq, hkv, C, C, d)
    seg = _pack(C, lengths, gap)
    want = packed_attention_pallas(jq[0], jk[0], jv[0], jnp.asarray(seg),
                                   softcap=softcap, interpret=True)
    st = torch.as_tensor(seg)
    i = torch.arange(C)
    vis = ((i[None, :] <= i[:, None]) & (st[:, None] == st[None, :])
           & (st[:, None] >= 0))
    plan = attention_plan(d, C, packed=True, buffer=C)
    got = wgmma_emulation(q[0], k[0].repeat_interleave(hq // hkv, 0),
                          v[0].repeat_interleave(hq // hkv, 0), vis,
                          scale=1.0 / math.sqrt(d), bk=plan.bk,
                          softcap=softcap)
    _assert_close(got, want)
    assert not got[:, seg < 0].float().any()      # pad rows exactly 0


def test_emulation_pad_route_matches_unpadded():
    """The wrapper's pad route (d = 100 read as 128 zero-padded dims,
    the scale of d = 100) gives what the unpadded arithmetic gives."""
    rng = np.random.default_rng(100)
    (q, k, v), _ = _inputs(rng, 1, 2, 2, 150, 150, 100)
    plain = _flash_emulated(q, k, v, causal=True, window=None, s_q=150,
                            s_kv=150)
    qp, kp, vp = pad_head_dim((q, k, v), 128)
    i = torch.arange(150)
    vis = i[None, :] <= i[:, None]
    padded = wgmma_emulation(qp[0], kp[0], vp[0], vis,
                             scale=1.0 / math.sqrt(100), bk=64)[..., :100]
    _assert_close(padded, plain[0].float().numpy())
