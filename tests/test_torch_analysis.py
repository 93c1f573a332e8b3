"""The dry-run's analysis tools: ``launch.hlo_analysis.collective_bytes``
on profiler traces, the by-kind collective counters of the train step's
model group, and ``launch.roofline`` against the JAX package's.

* A train step of recurrentgemma's SMOKE config on a 1x2 gloo world of
  CPU ranks (the launcher's rules: the attention in the head_dim layout,
  the RG-LRU on each rank's channels), profiled: its
  ``model_bytes_by_kind`` equals the shapes the layers gather and
  scatter (q and k gathered whole for RoPE, their gradients
  reduce-scattered; the RG-LRU's gate sums reduce-scattered forward and
  gathered backward), and the trace's ``collective_bytes`` equals the
  ``Comm`` counters, kind by kind.
* ``model_flops`` and ``roofline_row`` given the reference's constants
  equal the reference's on ``tests/test_analysis.py``'s record, but for
  the memory term: the port reports the analytic floor, where the
  reference takes the larger of it and a fixed share of the unfused
  bytes (a TPU fusion factor the port does not carry).

Exact equality throughout: these are counts.
"""
import numpy as np
import pytest

from repro.launch import roofline as jroof
from repro_torch.configs import get_smoke
from repro_torch.distributed.comm import KINDS
from repro_torch.launch import roofline
from repro_torch.launch.hlo_analysis import collective_bytes

import _torch_world as W

F32 = 4


@pytest.fixture(scope="module")
def profiled(tmp_path_factory):
    trace_dir = tmp_path_factory.mktemp("traces")
    return W.world(W.profiled_model_step, "recurrentgemma_2b", str(trace_dir),
                   tmp_path=tmp_path_factory.mktemp("analysis"), p=2)


def test_model_bytes_count_the_head_dim_gathers(profiled):
    cfg = get_smoke("recurrentgemma_2b")
    m = 2
    kinds = [cfg.block_pattern[i % len(cfg.block_pattern)]
             for i in range(cfg.n_layers)]
    n_attn, n_rglru = kinds.count("attn"), kinds.count("rglru")
    for r in profiled:
        b, s = r["batch"]
        qk = b * s * cfg.hd * (cfg.n_heads + cfg.n_kv_heads) * F32
        gates = 2 * b * s * cfg.lru_width * F32       # a and i together
        got = r["by_kind"]
        assert got["all-gather"] == n_attn * qk + n_rglru * gates
        assert got["reduce-scatter"] == (n_attn * qk + n_rglru * gates) // m
        assert got["all-reduce"] > 0 and got["all-to-all"] == 0
        assert got == r["counters"]


def test_trace_collective_bytes_equal_the_counters(profiled):
    for r in profiled:
        got = collective_bytes(r["trace"])
        for k in KINDS:
            assert got[k] == r["counters"][k], k
        assert got["total"] == sum(r["counters"].values())
        assert got["n_while_loops"] == 0


def test_dry_comm_spans_are_read_as_result_shapes():
    trace = {"traceEvents": [
        {"ph": "X", "pid": 1, "ts": 1, "name": "dry_comm::all-gather "
         "bf16[16,4096]"},
        {"ph": "X", "pid": 1, "ts": 2, "name": "dry_comm::reduce-scatter "
         "f32[2,64]"},
        {"ph": "X", "pid": 1, "ts": 3, "name": "dry_comm::all-reduce f32[]"},
        {"ph": "X", "pid": 1, "ts": 4, "name": "aten::mm"}]}
    got = collective_bytes(trace)
    assert got["all-gather"] == 16 * 4096 * 2
    assert got["reduce-scatter"] == 2 * 64 * 4
    assert got["all-reduce"] == 4
    assert got["total"] == 16 * 4096 * 2 + 2 * 64 * 4 + 4


REF_HW = roofline.Hardware("the reference's constants", jroof.PEAK_FLOPS,
                           jroof.HBM_BW, jroof.LINK_BW, 0.0)


def _record():
    return {
        "arch": "x", "shape": "train_4k", "kind": "train", "chips": 256,
        "seq": 4096, "global_batch": 256,
        "n_active_params": 8e9, "n_params": 8e9,
        "flops_global": 5e16, "bytes_global_unfused": 1e15,
        "collective_bytes_per_device": {"total": 2e11},
        "memory_per_device": {"argument_bytes": 2e9, "output_bytes": 2e9,
                              "temp_bytes": 5e10},
    }


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_model_flops_matches_the_reference(kind):
    rec = dict(_record(), kind=kind)
    assert roofline.model_flops(rec) == jroof.model_flops(rec)


def test_roofline_row_matches_the_reference_but_the_fusion_factor():
    rec = _record()
    got, want = roofline.roofline_row(rec, hw=REF_HW), jroof.roofline_row(rec)
    for k, v in want.items():
        if k == "t_memory_s":
            continue
        assert got[k] == v, k
    floor = jroof.analytic_memory_bytes(rec) / jroof.HBM_BW
    assert got["t_memory_s"] == floor
    assert want["t_memory_s"] == max(floor, want["t_memory_raw_unfused_s"]
                                     * jroof.FUSION_FACTOR)


def test_h100_row_names_its_card():
    row = roofline.roofline_row(_record())
    assert row["hardware"] == roofline.H100.name
    assert np.isclose(row["t_compute_s"], 5e16 / 256 / 989e12)
    assert row["bottleneck"] in ("compute", "memory", "collective")
