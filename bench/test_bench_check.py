"""CPU tests of the comparison that decides ``correct``: the reference
against frozen values of the plain DLB step, the judge on the program at
a tiny size, and the control and the faults that it has to refuse."""
import numpy as np
import pytest
import torch

from bench import check, control, harness
from bench.reference import dlb

P = 8
K, ITERS = 8, 12
# the plain DLB step (the port's CPU path) on ``_inputs()``, frozen: a
# cold repartition, then a warm one from old parts that are a relabelled
# copy of the first's, so the remap has to undo the relabelling
FROZEN = [
    {"parts": "6436274256437405172144402676235271127023725001352753172554"
              "5301054107036625627303777636043705526312764017112646645056"
              "2151344502761725503573516234533411514765471152723355344543"
              "2041230327266136677630157047521056571422230725470050606037"
              "646442330733126700710165",
     "splitters": [9140075.0, 50617768.0, 58674148.0, 64882352.0,
                   1013189888.0, 1057777472.0, 1067935680.0],
     "perm": [0, 1, 2, 3, 4, 5, 6, 7], "migration": (0.0, 0.0, 0.0),
     "part_weights": [116.0, 124.0, 124.0, 119.0, 122.0, 121.0, 124.0,
                      122.0], "rounds": 11},
    {"parts": "3220765703526510437455517363720764476142370114207602467055"
              "0214102416173370376212666373152610073247605146147350350153"
              "4404255017634670012062043725022544045635564407372200722052"
              "4154721246733423366321406156074103064277721670561101313126"
              "353554721322473611311430",
     "splitters": [9521165.0, 52746008.0, 59702868.0, 66791300.0,
                   1013544064.0, 1058279680.0, 1068662720.0],
     "perm": [1, 4, 7, 2, 5, 0, 3, 6], "migration": (91.0, 25.0, 943.0),
     "part_weights": [129.0, 122.0, 124.0, 127.0, 136.0, 133.0, 134.0,
                      129.0], "rounds": 9},
]


def _inputs():
    rng = np.random.default_rng(5)
    coords = torch.as_tensor(
        (rng.random((256, 3)) * [4.0, 1.0, 1.0]).astype(np.float32))
    w1 = torch.as_tensor(2.0 ** rng.integers(0, 4, 256)).float()
    w2 = torch.as_tensor(2.0 ** rng.integers(0, 4, 256)).float()
    return coords, w1, w2


def _steps():
    coords, w1, w2 = _inputs()
    r1 = dlb.balance(coords, w1, None, P, k=K, iters=ITERS)
    old = (r1.parts * 3 + 1) % P
    r2 = dlb.balance(coords, w2, old, P, k=K, iters=ITERS,
                     warm=r1.splitters)
    return coords, [(w1, None, r1), (w2, old, r2)]


@pytest.mark.parametrize("i", [0, 1])
def test_reference_matches_the_frozen_plain_step(i):
    _, steps = _steps()
    _, _, r = steps[i]
    want = FROZEN[i]
    assert "".join(map(str, r.parts.tolist())) == want["parts"]
    assert r.splitters.tolist() == want["splitters"]
    assert r.remap_perm.tolist() == want["perm"]
    assert (float(r.total_v), float(r.max_v),
            float(r.retained)) == want["migration"]
    assert r.part_weights.tolist() == want["part_weights"]
    assert r.ksection_rounds == want["rounds"]


def test_judge_reads_the_frozen_steps_as_exact():
    coords, steps = _steps()
    judge = check.Judge(coords, P)
    for w, old, r in steps:
        got = judge.judge(w, old, r)
        assert got["parts_mismatch"] == 0
        assert got["part_weight_gap"] == 0
        assert got["imbalance_excess"] == pytest.approx(0.0, abs=1e-12)
        assert got.get("migration_gap", 0) == 0
        assert ("migration_gap" in got) == (old is not None)
        assert got["imbalance_gap"] < 1e-6


def test_judge_refuses_a_relabelling_left_out():
    """Old parts whose labels are permuted: the program without its remap
    reports migration metrics true to its own parts, and the judge, which
    relabels by the reference's greedy, refuses them."""
    from repro_torch.core import Balancer, BalanceSpec
    coords, w1, w2 = _inputs()
    r1 = dlb.balance(coords, w1, None, P, k=K, iters=ITERS)
    old = (r1.parts * 3 + 1) % P
    spec = BalanceSpec(p=P, method="hsfc", oneD="ksection", k=K,
                       iters=ITERS, warm_start=True, use_remap=False)
    res = Balancer(spec, "cpu").balance(w2, coords=coords, old_parts=old,
                                        warm_splitters=r1.splitters)
    got = check.Judge(coords, P).judge(w2, old, res)
    assert got["parts_mismatch"] == 0
    limit = harness.find_cell(harness.load_benchmark(),
                              "ex31_steady")["limits"]["migration_gap"]
    assert got["migration_gap"] > 1000 * limit


def test_exact_partition_puts_each_atom_below_its_target():
    """The ideal parts: an atom goes to #{j : W j / p < F(atom)}, F its
    cumulative weight with it; checked against a direct count."""
    coords, w1, _ = _inputs()
    judge = check.Judge(coords, P)
    w64 = w1.double()
    got = judge.ideal_part_weights(w64)
    order = torch.argsort(judge.kf, stable=True)
    ks, ws = judge.kf[order], w64[order]
    W = float(ws.sum())
    want = torch.zeros(P, dtype=torch.float64)
    for a in torch.unique(ks):
        F = float(ws[ks <= a].sum())
        part = sum(W * j / P < F for j in range(1, P))
        want[part] += float(ws[ks == a].sum())
    assert torch.equal(got, want)
    assert float(got.sum()) == W


def _tiny_cell(workload, n=1 << 12, p=16):
    cell = harness.find_cell(harness.load_benchmark(), workload)
    cell["config"]["n"] = n
    cell["config"]["spec"]["p"] = p
    return cell


WORKLOADS = [w["name"] for w in harness.load_benchmark()["workloads"]]


def _run(workload, **kw):
    return harness.run_cell(_tiny_cell(workload), 2 ** 31 + 11, 0.05, False,
                            "cpu", 0.0, min_reps=4, **kw)


@pytest.mark.parametrize("workload", WORKLOADS)
def test_program_at_a_tiny_size_is_correct(workload):
    out = _run(workload)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"


@pytest.mark.parametrize("workload", WORKLOADS)
def test_reference_in_float32_in_the_programs_place_is_correct(workload):
    out = _run(workload, balancer=control.control_factory(torch.float32))
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("workload", WORKLOADS)
def test_control_in_bfloat16_is_refused(workload):
    out = _run(workload, balancer=control.control_factory(torch.bfloat16))
    assert not out["correct"]
    assert out["failed"] > 0


class _Faulty:
    """The program's ``Balancer`` with one fault planted where its answer
    is produced."""

    def __init__(self, spec, device, fault):
        from repro_torch.core import Balancer
        self.bal, self.fault, self.prev = Balancer(spec, device), fault, None

    def balance(self, weights, *, coords, old_parts=None):
        if self.fault == "unchanged" and self.prev is not None:
            return self.prev
        if self.fault == "half":
            # half of the items left out, the rest balanced alone
            weights = weights.clone()
            weights[weights.shape[0] // 2:] = 0
        res = self.bal.balance(weights, coords=coords, old_parts=old_parts)
        if self.fault == "altered":
            res.parts = res.parts.clone()
            res.parts[7] = (res.parts[7] + 1) % self.bal.spec.p
        self.prev = res
        return res


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_faults_of_the_timed_path_are_refused(workload, fault):
    from repro_torch.core import Balancer
    if fault == "unchanged" and workload == "ex31_initial":
        # a fresh Balancer each repartition: a fault that returns the
        # previous call's answer returns the previous field's parts
        prev = {}

        def make(spec, device):
            bal = Balancer(spec, device)
            real = bal.balance

            def balance(weights, **kw):
                if "res" not in prev:
                    prev["res"] = real(weights, **kw)
                return prev["res"]
            bal.balance = balance
            return bal
    else:
        def make(spec, device):
            return _Faulty(spec, device, fault)
    out = _run(workload, balancer=make)
    assert not out["correct"], (fault, out["checks"])
