"""The port's kernel dispatch and plain versions against the JAX package's
oracles and its Pallas kernels (interpret mode), on the CPU.

The hand-written CUDA kernels themselves run only on a card; they are
held against these plain versions in test_torch_cuda.py (which imports
no JAX, so it runs on the machine with the card) and by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.fem_matvec import fem_element_matrices as j_element_matrices
from repro.kernels.fem_matvec import fem_matvec_pallas
from repro.kernels.ksection_hist import ksection_histogram_pallas
from repro_torch.core import sfc as tsfc
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fem_matvec import (fem_element_matrices,
                                            fem_matvec_cuda)
from repro_torch.kernels.ksection_hist import ksection_hist_cuda
from repro_torch.kernels.sfc_keys import sfc_keys_cuda


# --- sfc_keys --------------------------------------------------------------

def _grid(n, bits, seed):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 1 << bits, (n, 3))
    top = (1 << bits) - 1
    g[:4] = [[0, 0, 0], [top, top, top], [0, top, 0], [top, 0, top]]
    return g


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
@pytest.mark.parametrize("bits", list(range(1, 11)))
def test_sfc_keys_plain_bit_exact(curve, bits):
    g = _grid(1000 + bits, bits, bits)      # n not a multiple of any block
    fn = jref.hilbert_keys_ref if curve == "hilbert" else jref.morton_keys_ref
    want = np.asarray(fn(jnp.asarray(g.astype(np.uint32)), bits))
    got = ops.sfc_keys_op(torch.as_tensor(g), curve=curve, bits=bits)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("curve", ["morton", "hilbert"])
def test_sfc_keys_plain_matches_pallas_kernel(curve):
    g = _grid(1000, 10, 7)
    want = np.asarray(jops.sfc_keys_op(jnp.asarray(g.astype(np.uint32)),
                                       curve=curve, use_pallas=True,
                                       interpret=True))
    got = ops.sfc_keys_op(torch.as_tensor(g), curve=curve).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("bits", [3, 10])
def test_sfc_decoders_invert_and_match(bits):
    g = _grid(500, bits, 3)
    gt = torch.as_tensor(g)
    for enc, dec in ((tsfc.morton_encode, tsfc.morton_decode),
                     (tsfc.hilbert_encode, tsfc.hilbert_decode)):
        np.testing.assert_array_equal(dec(enc(gt, bits), bits).numpy(), g)


# --- ksection_hist -----------------------------------------------------------
# Integer weights make every partial sum exact: the plain version, the JAX
# oracle and the Pallas kernel agree bit for bit.

def _hist_case(n, m, seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 50, n).astype(np.float32)      # many duplicates
    w = rng.integers(0, 10, n).astype(np.float32)
    cuts = rng.integers(0, 52, m).astype(np.float32)      # unsorted, dups
    if m > 2 and n > 0:
        cuts[:2] = keys[:2]                                # cut == key
    return keys, w, cuts


@pytest.mark.parametrize("n,m", [(1000, 37), (4096, 504), (3, 1), (1, 9),
                                 (0, 5), (7, 0), (0, 0)])
def test_ksection_hist_plain_exact(n, m):
    keys, w, cuts = _hist_case(n, m, n + m)
    got = ops.ksection_histogram_op(torch.as_tensor(keys), torch.as_tensor(w),
                                    torch.as_tensor(cuts))
    assert got.dtype == torch.float32 and got.shape == (m,)
    want = np.asarray(jref.ksection_histogram_ref(
        jnp.asarray(keys), jnp.asarray(w), jnp.asarray(cuts)))
    np.testing.assert_array_equal(got.numpy(), want)
    if n >= 1000 and m:
        pallas = np.asarray(ksection_histogram_pallas(
            jnp.asarray(keys), jnp.asarray(w), jnp.asarray(cuts),
            interpret=True))
        np.testing.assert_array_equal(got.numpy(), pallas)


def test_ksection_hist_sentinel_tail():
    """+inf keys with zero weight (the padded tail) count for no cut."""
    keys, w, cuts = _hist_case(600, 40, 1)
    keys[-100:] = np.inf
    w[-100:] = 0.0
    got = ops.ksection_histogram_op(torch.as_tensor(keys), torch.as_tensor(w),
                                    torch.as_tensor(cuts)).numpy()
    want = np.asarray(ksection_histogram_pallas(
        jnp.asarray(keys), jnp.asarray(w), jnp.asarray(cuts), interpret=True))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        got, ops.ksection_histogram_op(torch.as_tensor(keys[:-100]),
                                       torch.as_tensor(w[:-100]),
                                       torch.as_tensor(cuts)).numpy())


# --- fem_matvec --------------------------------------------------------------

def _matvec_case(C, V, n_out, seed):
    rng = np.random.default_rng(seed)
    tets = rng.integers(0, n_out + 1, (C, 4)).astype(np.int32)  # incl. pad slot
    grads = rng.standard_normal((C, 4, 3)).astype(np.float32)
    vol = rng.random(C).astype(np.float32)
    vol[::7] = 0.0                                              # no-op rows
    # the pad slot belongs to padding elements only, which carry K_e = 0
    # (the JAX implementations read a different value there)
    vol[(tets == n_out).any(axis=1)] = 0.0
    u = rng.standard_normal(V).astype(np.float32)
    return tets, grads, vol, u


@pytest.mark.parametrize("C,V,n_out,c", [(300, 80, 80, 0.0),
                                         (300, 96, 80, 1.5),
                                         (257, 40, 33, 0.0),
                                         (0, 10, 10, 0.0)])
def test_fem_matvec_plain_matches_reference(C, V, n_out, c):
    tets, grads, vol, u = _matvec_case(C, V, n_out, C + V)
    jkel = j_element_matrices(jnp.asarray(grads), jnp.asarray(vol), c)
    kel = fem_element_matrices(torch.as_tensor(grads), torch.as_tensor(vol), c)
    np.testing.assert_allclose(kel.numpy(), np.asarray(jkel), rtol=1e-5,
                               atol=1e-6)
    want = np.asarray(jref.fem_matvec_ref(jnp.asarray(tets), jnp.asarray(grads),
                                          jnp.asarray(vol), jnp.asarray(u),
                                          n_out, c=c))
    tol = dict(rtol=1e-5, atol=1e-5 * max(np.abs(want).max(initial=0.0), 1.0))
    got = ops.fem_matvec_op(torch.as_tensor(tets), kel, torch.as_tensor(u),
                            n_out)
    assert got.shape == (n_out,)
    np.testing.assert_allclose(got.numpy(), want, **tol)
    geom = ref.fem_matvec_ref(torch.as_tensor(tets), torch.as_tensor(grads),
                              torch.as_tensor(vol), torch.as_tensor(u), n_out,
                              c=c)
    np.testing.assert_allclose(geom.numpy(), want, **tol)
    if C:
        pallas = np.asarray(fem_matvec_pallas(jnp.asarray(tets), jkel,
                                              jnp.asarray(u), n_out,
                                              interpret=True))
        np.testing.assert_allclose(got.numpy(), pallas, **tol)


# --- dispatch ----------------------------------------------------------------

def _cpu_inputs():
    keys, w, cuts = _hist_case(100, 9, 0)
    tets, grads, vol, u = _matvec_case(20, 12, 12, 0)
    kel = fem_element_matrices(torch.as_tensor(grads), torch.as_tensor(vol))
    return (torch.as_tensor(_grid(50, 10, 0)), torch.as_tensor(keys),
            torch.as_tensor(w), torch.as_tensor(cuts), torch.as_tensor(tets),
            kel, torch.as_tensor(u))


def test_ops_on_cpu_run_plain_versions_with_no_launch():
    grid, keys, w, cuts, tets, kel, u = _cpu_inputs()
    ops.reset_launch_counts()
    for use in (None, False):
        ops.sfc_keys_op(grid, use_pallas=use)
        ops.ksection_histogram_op(keys, w, cuts, use_pallas=use)
        ops.fem_matvec_op(tets, kel, u, 12, use_pallas=use)
    assert ops.launch_counts() == {"sfc_keys": 0, "ksection_hist": 0,
                                   "fem_matvec": 0}


def test_use_pallas_true_on_cpu_raises():
    grid, keys, w, cuts, tets, kel, u = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        ops.sfc_keys_op(grid, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.ksection_histogram_op(keys, w, cuts, use_pallas=True)
    with pytest.raises(ValueError, match="CUDA"):
        ops.fem_matvec_op(tets, kel, u, 12, use_pallas=True)


def test_kernel_wrappers_reject_cpu_tensors():
    grid, keys, w, cuts, tets, kel, u = _cpu_inputs()
    with pytest.raises(ValueError, match="CUDA"):
        sfc_keys_cuda(grid.to(torch.int32))
    with pytest.raises(ValueError, match="CUDA"):
        ksection_hist_cuda(keys, w, cuts)
    with pytest.raises(ValueError, match="CUDA"):
        fem_matvec_cuda(tets, kel, u, 12)
