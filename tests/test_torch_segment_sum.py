"""The any-order segment sum's dispatch and the kernel wrapper's checks
and route choice, on the CPU (``repro_torch.segment.segment_sum_any_order``,
``repro_torch.kernels.segment_sum``).

The kernel itself runs only on a card: test_torch_cuda.py holds it
against ``index_add_`` there.  Here the plain route must be the
``index_add_`` sum it always was, and the wrapper must refuse what the
kernel does not take before it builds anything.
"""
import numpy as np
import pytest
import torch

from repro_torch.core.remap import similarity_matrix
from repro_torch.kernels import build
from repro_torch.kernels import segment_sum as ss
from repro_torch.segment import segment_sum_any_order

#: the H100's opt-in shared memory a block (sm_90a)
H100_SMEM = 232_448


def _old_index_add(data, ids, num_segments):
    """``segment_sum_any_order`` as it was: masked ``index_add_``."""
    ids = ids.reshape(-1).long()
    out = data.new_zeros((num_segments,) + tuple(data.shape[1:]))
    if num_segments == 0 or ids.numel() == 0:
        return out
    valid = (ids >= 0) & (ids < num_segments)
    rows = valid.view((-1,) + (1,) * (data.dim() - 1))
    return out.index_add_(0, torch.where(valid, ids, 0),
                          torch.where(rows, data, 0))


def _case(n, num_segments, seed, id_dtype):
    """Random float32 weights and ids with a share outside the range: -1,
    -7, ``num_segments`` (the balancer's pad part) and past it."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, num_segments, n)
    out = rng.random(n) < 0.1
    ids[out] = rng.choice([-1, -7, num_segments, num_segments + 5],
                          int(out.sum()))
    w = rng.standard_normal(n).astype(np.float32)
    return torch.as_tensor(w), torch.as_tensor(ids, dtype=id_dtype)


@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("use", [None, False])
@pytest.mark.parametrize("n,num_segments", [(0, 5), (1, 1), (31, 256),
                                            (5000, 1024), (3000, 0)])
def test_plain_route_is_the_old_index_add(n, num_segments, use, id_dtype):
    w, ids = _case(n, max(num_segments, 1), n + num_segments, id_dtype)
    got = segment_sum_any_order(w, ids, num_segments, use_pallas=use)
    assert got.dtype == torch.float32 and got.shape == (num_segments,)
    assert torch.equal(got, _old_index_add(w, ids, num_segments))


def test_plain_route_keeps_rows_and_other_types():
    """The plain route sums rows of any type, as ``index_add_`` does."""
    w, ids = _case(400, 30, 3, torch.int64)
    rows = torch.stack([w, 2 * w], dim=1).double()
    got = segment_sum_any_order(rows, ids, 30)
    assert got.dtype == torch.float64 and got.shape == (30, 2)
    assert torch.equal(got, _old_index_add(rows, ids, 30))


def test_similarity_matrix_plain_route():
    rng = np.random.default_rng(4)
    old = torch.as_tensor(rng.integers(0, 9, 2000))   # 8: the pad part
    new = torch.as_tensor(rng.integers(0, 8, 2000))
    w = torch.as_tensor(rng.integers(1, 5, 2000).astype(np.float32))
    S = similarity_matrix(old, new, w, 8, 8, use_pallas=False)
    assert torch.equal(S, similarity_matrix(old, new, w, 8, 8))
    want = torch.zeros((8, 8))
    for i, j, x in zip(old.tolist(), new.tolist(), w.tolist()):
        if i < 8:
            want[i, j] += x
    assert torch.equal(S, want)


def test_use_pallas_true_on_cpu_raises():
    w, ids = _case(100, 10, 5, torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        segment_sum_any_order(w, ids, 10, use_pallas=True)


def _refuse_build():
    raise AssertionError("the wrapper built the library before its checks")


@pytest.mark.parametrize("case,match", [
    ("cpu", "CUDA tensors"),
    ("2-D data", "data must be"),
    ("float64 data", "data must be"),
    ("float ids", "ids must be"),
    ("lengths", "differ in length"),
])
def test_wrapper_checks_raise_before_any_build(monkeypatch, case, match):
    monkeypatch.setattr(build, "library", _refuse_build)
    w, ids = _case(64, 8, 6, torch.int64)
    data = {"2-D data": w.reshape(16, 4), "float64 data": w.double()}.get(
        case, w)
    ids = {"float ids": ids.float(), "lengths": ids[:63]}.get(case, ids)
    with pytest.raises(ValueError, match=match):
        ss.segment_sum_cuda(data, ids, 8)


@pytest.mark.parametrize("num_segments,want", [
    (1, ("shared", 16)), (255, ("shared", 16)), (256, ("shared", 16)),
    (1024, ("shared", 16)), (8191, ("shared", 2)), (16384, ("shared", 1)),
    (H100_SMEM // 4, ("shared", 1)), (H100_SMEM // 4 + 1, ("global", 0)),
    (65536, ("global", 0)), (1_048_576, ("global", 0)),
])
def test_route_follows_the_bin_count(num_segments, want):
    """One copy a warp while copies x bins x 4 B stays within the budget
    (64 KB), fewer above it, down to one a block while the bins fit in
    the block's shared memory; global atomics past that."""
    assert ss.route(num_segments, H100_SMEM) == want
    assert ss.route(num_segments) == want     # the default: sm_90a's limit
    kind, copies = want
    if kind == "shared":
        assert 4 * num_segments * copies <= max(ss.COPY_BUDGET,
                                                4 * num_segments)
        assert 1 <= copies <= ss.WARPS


def test_route_follows_the_shared_memory_budget():
    assert ss.route(1024, 48 * 1024) == ("shared", 16)
    assert ss.route(12_288, 48 * 1024) == ("shared", 1)
    assert ss.route(12_289, 48 * 1024) == ("global", 0)
