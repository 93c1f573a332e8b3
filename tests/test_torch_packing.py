"""The balanced training-data packer against the JAX package, on the CPU:
the cost model, the greedy baseline, the synthetic corpus and the packed
batches equal exactly; ``balanced_pack``'s rows, imbalance and (with old
rows) TotalV / MaxV / retained equal on the same lengths, for the
'sorted' and the 'ksection' 1-D solvers.  Token counts are integer
valued, so the port's balancer gives the reference's parts bit for bit
(and the float metrics to the bit: both sum integers in float32)."""
import numpy as np
import pytest
from _propcheck import given, settings, strategies as st

from repro import data as jdata
from repro_torch import data as tdata


def _lengths(seed, n=256):
    rng = np.random.default_rng(seed)
    return np.maximum(8, rng.lognormal(5.0, 0.8, n)).astype(np.int64)


def test_attention_cost_equal():
    lens = _lengths(0)
    np.testing.assert_array_equal(tdata.attention_cost(lens),
                                  jdata.attention_cost(lens))
    np.testing.assert_array_equal(tdata.attention_cost(lens, window=512),
                                  jdata.attention_cost(lens, window=512))


def test_greedy_pack_equal():
    lens = _lengths(1)
    rows, info = tdata.greedy_pack(lens, 16)
    jrows, jinfo = jdata.greedy_pack(lens, 16)
    np.testing.assert_array_equal(rows, jrows)
    assert info == jinfo


def test_synthetic_corpus_equal():
    docs = tdata.SyntheticCorpus(vocab=512, seed=3).documents(40)
    jdocs = jdata.SyntheticCorpus(vocab=512, seed=3).documents(40)
    assert len(docs) == len(jdocs)
    for a, b in zip(docs, jdocs):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("balanced", [True, False])
def test_pack_batches_equal(balanced):
    docs = jdata.SyntheticCorpus(vocab=512, seed=0).documents(96)
    got = list(tdata.pack_batches(docs, 8, 512, vocab=512, device="cpu",
                                  balanced=balanced))
    want = list(jdata.pack_batches(docs, 8, 512, vocab=512,
                                   balanced=balanced))
    assert len(got) == len(want) >= 2
    for g, w in zip(got, want):
        for k in ("tokens", "labels"):
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def _check_pack(lengths, method, old=None, cost=None):
    rows, info = tdata.balanced_pack(lengths, 16, old_rows=old, cost=cost,
                                     method=method, device="cpu")
    jrows, jinfo = jdata.balanced_pack(lengths, 16, old_rows=old, cost=cost,
                                       method=method)
    np.testing.assert_array_equal(rows, np.asarray(jrows))
    assert info == jinfo, (info, jinfo)
    return rows, info


@pytest.mark.parametrize("method", ["sorted", "ksection"])
@given(st.integers(0, 2**32 - 1))
@settings(max_examples=6, deadline=None)
def test_balanced_pack_equal_with_and_without_old_rows(method, seed):
    lengths = _lengths(seed)
    rows, info = _check_pack(lengths, method)
    bound = 1.0 + 16 * lengths.max() / lengths.sum()
    assert info["imbalance"] <= bound + 1e-3
    lengths2 = lengths.copy()
    lengths2[:10] += 50
    rows2, info2 = _check_pack(lengths2, method, old=rows)
    assert set(info2) == {"TotalV", "MaxV", "retained", "imbalance"}
    assert (rows2 != rows).mean() < 0.6


def test_balanced_pack_with_cost_model_equal():
    lengths = _lengths(7)
    _check_pack(lengths, "sorted", cost=jdata.attention_cost(lengths))


def test_pack_batches_labels_are_next_tokens():
    docs = tdata.SyntheticCorpus(vocab=512, seed=0).documents(64)
    for b in tdata.pack_batches(docs, batch=8, seq_len=512, vocab=512,
                                device="cpu"):
        t, l = b["tokens"], b["labels"]
        assert t.shape == l.shape == (8, 512)
        m = l[:, :-1] >= 0
        assert (l[:, :-1][m] == t[:, 1:][m]).mean() > 0.95


def test_balanced_pack_refuses_a_missing_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdata.balanced_pack(_lengths(0), 16)
