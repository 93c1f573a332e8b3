"""The production dry-run (``launch.dryrun``) on the CPU.

* Against the reference: ``input_specs`` (shapes and types of every
  cell), ``cfg_accum`` and ``_dryrun_cfg`` equal the JAX package's
  (read in a subprocess: the reference's module pins 512 placeholder
  devices when it is imported).
* Against a real run: at SMOKE on a 2x2 mesh (a train cell of 64 x 8
  and a decode cell of 64 x 4), the meta count of each rank's step
  predicts a real 4-rank CPU run of the same cell over gloo exactly:
  the collective bytes of every kind, the parameter and moment bytes the
  rank holds, and the FLOPs the flop counter counts (remat recomputing
  whole layers on both sides: the CPU's bf16 products take another
  route than the meta device's, whose saved inputs would stop the
  recompute at another op).
* Every family's SMOKE config counts on the production mesh (16 x 16)
  with the reference's record keys, and the CLI writes a full-width
  record that ``launch.roofline`` reads.
Exact equality: these are counts.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest
from torch.utils.checkpoint import set_checkpoint_early_stop

from repro_torch.configs import (ARCH_IDS, LONG_OK, SHAPES, cells,
                                 get_config, get_smoke)
from repro_torch.launch import dryrun, roofline
from repro_torch.launch.mesh import ProductionMesh, make_production_mesh

import _torch_world as W

REF_KEYS = {"arch", "shape", "kind", "multi_pod", "chips", "seq",
            "global_batch", "n_params", "n_active_params", "flops_global",
            "bytes_global_unfused", "t_lower_unrolled_s", "t_lower_s",
            "t_compile_s", "memory_per_device",
            "collective_bytes_per_device", "compiled_flops_per_device_u1"}
REF_COLL = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
            "collective-permute", "total", "n_while_loops"}

_REFERENCE = r"""
import dataclasses, json
from repro.launch import dryrun as D
from repro.configs import ARCH_IDS, SHAPES, get_config
out = {}
for a in ARCH_IDS:
    base = get_config(a)
    cfg = D._dryrun_cfg(base, False)
    out[a] = {"cfg": json.loads(json.dumps(dataclasses.asdict(
                  D._dryrun_cfg(base, True)))),
              "accum": D.cfg_accum(cfg),
              "specs": {s: {k: [list(v.shape), str(v.dtype)]
                            for k, v in D.input_specs(a, s, cfg).items()}
                        for s in SHAPES}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(sys.path))
    res = subprocess.run([sys.executable, "-c", _REFERENCE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    return json.loads(res.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_accum_and_cfg_equal_the_reference(reference, arch):
    want = reference[arch]
    base = get_config(arch)
    got_cfg = json.loads(json.dumps(dataclasses.asdict(
        dryrun._dryrun_cfg(base, True))))
    assert got_cfg == want["cfg"]
    assert dryrun.cfg_accum(dryrun._dryrun_cfg(base, False)) == want["accum"]
    cfg = dryrun._dryrun_cfg(base, False)
    for s in SHAPES:
        got = {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
               for k, v in dryrun.input_specs(arch, s, cfg).items()}
        assert got == want["specs"][s], s


def test_cells_and_production_mesh():
    assert len(cells()) == 34
    assert all(s != "long_500k" or a in LONG_OK for a, s in cells())
    sp, mp = make_production_mesh(), make_production_mesh(multi_pod=True)
    assert (sp.shape, sp.names) == ((16, 16), ("data", "model"))
    assert mp.size == 512 and mp.names == ("pod", "data", "model")
    # jax.make_mesh's device order: the model axis fastest
    assert mp.coords(17) == {"pod": 0, "data": 1, "model": 1}
    assert mp.coords(256) == {"pod": 1, "data": 0, "model": 0}
    assert len(dryrun.all_cells()) == 68


MESH = (2, 2)
REAL_CELLS = {"train": ("llama3_8b", (64, 8, "train")),
              "decode": ("llama3_8b", (64, 4, "decode"))}


@pytest.fixture(scope="module")
def real(tmp_path_factory):
    out = {}
    for key, (arch, shape) in REAL_CELLS.items():
        out[key] = W.world(W.dryrun_real_cell, arch, shape, MESH,
                           tmp_path=tmp_path_factory.mktemp(key), p=4)
    return out


@pytest.mark.parametrize("key", list(REAL_CELLS))
def test_meta_count_predicts_a_real_2x2_run(real, key):
    """Both sides recompute remat's layers whole (``dryrun_real_cell``)."""
    arch, shape = REAL_CELLS[key]
    mesh = ProductionMesh(MESH, ("data", "model"))
    with set_checkpoint_early_stop(False):
        rec = dryrun.run_cell(arch, shape, multi_pod=False, device="meta",
                              cfg_override=get_smoke(arch), mesh=mesh)
    assert REF_KEYS <= set(rec)
    for rank, got in enumerate(real[key]):
        with set_checkpoint_early_stop(False):
            want = dryrun.count_step(dryrun.build_cell(
                arch, shape, multi_pod=False, unroll=False,
                cfg_override=get_smoke(arch), rank=rank, mesh=mesh))
        coll = want["collectives"]
        coll.pop("by_group")
        assert got["collectives"] == coll, rank
        assert got["flops"] == want["flops"], rank
        for name, n in got["args"].items():
            assert n == want["argument_bytes_by_name"][name], (rank, name)
        if rank == 0:
            assert rec["collective_bytes_per_device"] == coll
            assert rec["compiled_flops_per_device_u1"] == got["flops"]
    assert rec["collective_bytes_per_device"]["total"] > 0


@pytest.mark.parametrize("arch", ["llama3_8b", "phi35_moe_42b"])
def test_two_sampled_microbatches_count_the_whole_step(arch):
    """The meta count runs a train step's first two microbatches and
    counts the second for each other: the same FLOPs, bytes, collective
    bytes, argument and output bytes as the whole step of 4, exactly,
    and its peak within 1 % (later microbatches of the whole step keep
    a few kB more alive)."""
    def count(sample):
        cell = dryrun.build_cell(arch, (128, 256, "train"), multi_pod=False,
                                 unroll=False, cfg_override=get_smoke(arch),
                                 accum=4)
        got = dryrun.count_step(cell, sample=sample)
        got["collectives"].pop("by_group")
        return got
    got, want = count(True), count(False)
    peak, want_peak = (x["memory"].pop("temp_bytes") for x in (got, want))
    assert got == want
    assert abs(peak / want_peak - 1) <= 0.01


#: one serving cell of each family at SMOKE widths on the production mesh
FAMILY_CELLS = [(a, "long_500k" if a in LONG_OK else "decode_32k")
                for a in ARCH_IDS]


@pytest.mark.parametrize("arch,shape", FAMILY_CELLS)
def test_every_family_counts_on_the_production_mesh(arch, shape):
    rec = dryrun.run_cell(arch, shape, multi_pod=False, device="meta",
                          cfg_override=get_smoke(arch), flops_phase=False)
    assert REF_KEYS - {"flops_global", "bytes_global_unfused",
                       "t_lower_unrolled_s"} <= set(rec)
    assert REF_COLL <= set(rec["collective_bytes_per_device"])
    assert rec["chips"] == 256 and rec["rules"]["cache_seq"] == "model"
    mem = rec["memory_per_device"]
    assert mem["argument_bytes"] == sum(rec["argument_bytes_by_name"].values())
    assert mem["alias_bytes"] == rec["argument_bytes_by_name"]["state"]
    assert rec["compiled_flops_per_device_u1"] > 0


def test_prefill_counts_the_flash_kernel():
    """A prefill attends through the flash kernel; on meta its twin adds
    4 d FLOPs per attended (query, key) pair and head, which no counter
    sees otherwise."""
    cfg = get_smoke("llama3_8b")
    cell = dryrun.build_cell("llama3_8b", (256, 32, "prefill"),
                             multi_pod=False, unroll=False, cfg_override=cfg,
                             rank=None)
    assert cell.cfg.use_pallas
    counter = dryrun.OpCounter()
    with dryrun.meta_flash(counter), counter:
        cell.step()
    pairs = dryrun.flash_pairs(256, 256, True, None)
    assert counter.extra_flops == \
        4 * 32 * cfg.n_heads * cfg.hd * pairs * cfg.n_layers
    assert pairs == 256 * 257 // 2
    assert dryrun.flash_pairs(6, 6, True, 2) == 1 + 2 * 5
    assert dryrun.flash_pairs(3, 5, False, None) == 15


def test_cli_writes_records_roofline_reads(tmp_path, capsys):
    dryrun.main(["--device", "meta", "--arch", "llama3_8b", "--shape",
                 "decode_32k", "--out", str(tmp_path)])
    with open(tmp_path / "llama3_8b__decode_32k__sp.json") as f:
        rec = json.load(f)
    assert REF_KEYS <= set(rec)
    assert rec["n_params"] == get_config("llama3_8b").n_params()
    capsys.readouterr()
    roofline.main(["--dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert roofline.H100.name in out and "decode_32k" in out
