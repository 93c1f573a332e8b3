"""Training launcher.  Counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
        --smoke --device cpu --steps 8 --batch 4 --seq 128

Builds the model (random weights from a seed), AdamW with a warmup of
``max(steps // 10, 1)`` and a cosine over ``steps``, and trains on
balanced-packed batches of a synthetic corpus (``SyntheticCorpus(vocab,
seed=1).documents(2048)`` through ``pack_batches``, whose balancer runs
on the training device), with an async checkpoint every
``--ckpt-every`` steps and resume from the newest step under ``--ckpt``.
Runs on CUDA unless ``--device cpu``.

``--mesh DxM`` trains on D x M ranks (``distributed.run_world``, gloo;
on the card every rank shares cuda:0, on the CPU each is a CPU
process), as the reference's launcher does on a ``(D, M)`` mesh
(``launch.mesh.make_mesh``; rank r at data index r // M, model index
r % M).  Every rank packs the same global batch of ``--batch`` rows and
each data index takes its D-th of them.  On the model axis the rules
(``launch.mesh.train_rules``, the reference launcher's) put heads (or
head_dim, where the heads do not divide the production axis), MLP and
recurrent width, vocab and experts there, where M divides them: each
rank holds its slices of those leaves
(``distributed.sharding.model_slices``) and runs its part of every
layer (tensor- and expert-parallel, ``models.layers``, ``models.rglru``,
``models.moe``); a layer with no slice (mamba2's mixer) runs whole on
every model rank.  A leaf on "model" that M does not split
(recurrentgemma's RG-LRU width at M = 3) raises ``ValueError`` before
any rank starts.  The gradients are summed over the data group, the
AdamW moments of each rank's slices are sharded ZeRO-style over it
(``train.zero_shards``), and checkpoints keep the one-rank layout, so a
run resumes onto any mesh.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
        --smoke --device cpu --mesh 2x2 --steps 8 --batch 8 --seq 128
    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch recurrentgemma_2b --smoke --device cpu --mesh 1x4 --steps 4

``train(cfg, ...)`` is the loop (``data=`` and ``model=``, a rank's
``Comm`` of its data and model group); ``main`` parses the arguments and
calls it, or starts the ranks that do, and ``chip_smoke.py`` calls it
with a config whose depth is cut.
"""
from __future__ import annotations

import argparse
import os
import tempfile
from typing import Callable, Dict, Iterator, Optional

import torch

from ..configs import get_config, get_smoke
from ..data import SyntheticCorpus, pack_batches
from ..device import resolve_device
from ..distributed.sharding import model_slices
from ..models import ModelConfig, init_model
from ..train import (AdamWConfig, AsyncCheckpointer, Shard, init_opt_state,
                     latest_step, make_train_step, restore, restore_sharded,
                     save_sharded, zero_shards)
from ..train.train_step import device_clock
from .mesh import make_mesh, train_rules

#: seconds a data-parallel world of ``main`` may run before its ranks are
#: stopped (a collective that hangs fails after its own 600 s timeout)
WORLD_S = 86400.0


def corpus_stream(cfg: ModelConfig, batch: int, seq: int, device
                  ) -> Iterator[Dict]:
    """Packed batches of the synthetic corpus, endlessly: the 2,048
    documents again from the first once they run out."""
    docs = SyntheticCorpus(vocab=cfg.vocab, seed=1).documents(2048)
    while True:
        yield from pack_batches(docs, batch, seq, vocab=cfg.vocab,
                                device=device)


def data_shards(cfg: ModelConfig, lm: torch.nn.Module, data, m: int = 1
                ) -> Optional[Dict[str, Shard]]:
    """``zero_shards`` of this rank of the data group ``data`` under the
    launcher's rules on a model axis of ``m`` (``train_rules``), of the
    parameters ``lm`` holds (a model rank's slices); None without a data
    group."""
    if data is None:
        return None
    return zero_shards(cfg, lm, train_rules(cfg, m), data.size, data.rank)


def rows_of(hb: Dict, data) -> Dict:
    """This rank's contiguous rows ``[r B/D, (r+1) B/D)`` of a global
    batch (the reference's ``P("data", None)``); the whole batch without
    a data group."""
    if data is None:
        return hb
    b = next(iter(hb.values())).shape[0]
    if b % data.size:
        raise ValueError(f"a global batch of {b} rows does not split over "
                         f"{data.size} data ranks")
    per = b // data.size
    return {k: v[data.rank * per:(data.rank + 1) * per]
            for k, v in hb.items()}


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 8,
          seq: int = 256, lr: float = 3e-4,
          ckpt: Optional[str] = "ckpts_launch", ckpt_every: int = 10,
          device=None, batches: Optional[Iterator] = None,
          log: Callable = print, data=None, model=None,
          on_step: Optional[Callable] = None) -> Dict:
    """Train ``cfg`` for ``steps`` steps (from the newest checkpoint under
    ``ckpt``, if any; ``ckpt=None`` neither reads nor writes any).
    ``batches`` replaces the corpus stream (an iterator of dicts of
    numpy arrays: global batches).  Returns ``{"model", "opt", "start",
    "history"}``: ``history`` holds a dict a step taken -- ``step``,
    ``loss``, ``gnorm``, ``lr`` and the seconds of packing (``t_pack``:
    the next batch packed and this rank's rows copied to the device),
    forward + backward (``t_grad``) and update (``t_update``), each with
    the device synchronized.

    With ``data`` (this rank's ``Comm`` of the data group), each rank
    takes its rows of every global batch of ``batch`` rows, and trains
    with the moments sharded (``opt`` holds this rank's parts); the
    history adds the gradient all-reduce (``t_reduce``), the parameters'
    all-gather within the update (``t_gather``) and the bytes this rank
    handed to each (``reduce_bytes``, ``gather_bytes``).  Checkpoints
    are written in the one-rank layout by rank 0.

    With ``model`` (this rank's ``Comm`` of the model group), the model
    holds this rank's slices under ``train_rules(cfg, model.size)`` (the
    ``"model"`` of the result too), and the history adds the host
    seconds of the model group's all-reduces (``t_model``, within
    ``t_grad`` and ``t_update``) and the bytes this rank handed to them
    (``model_bytes``), and the model group's collectives by kind
    (``model_bytes_by_kind``, ``t_model_by_kind``: the head_dim layout's
    all-gathers and reduce-scatters as well).  ``on_step(step, model, grads, metrics)``, if
    given, sees each step's summed gradients (before the update consumed
    them) and the updated model."""
    dev = resolve_device(device)
    ocfg = AdamWConfig(lr=lr, warmup=max(steps // 10, 1), total_steps=steps)
    rank = 0 if data is None else data.rank
    m = 1 if model is None else model.size
    lead = rank == 0 and (model is None or model.rank == 0)
    if lead:
        log(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
            f"device={dev} mesh={1 if data is None else data.size}x{m}")
    rules = train_rules(cfg, m)
    slices = (None if model is None
              else model_slices(cfg, rules, m, model.rank))
    net = init_model(cfg, seed=0, device=dev, slices=slices)
    shards = data_shards(cfg, net, data, m)
    opt = init_opt_state(net, ocfg, shards, rank)
    whole = data is None and model is None
    start = 0
    if ckpt and latest_step(ckpt) is not None:
        if whole:
            start, state = restore(ckpt, template={"params": net, "opt": opt})
            opt = state["opt"]
        else:
            start, opt = restore_sharded(ckpt, net, ocfg, shards, rank,
                                         slices=slices)
        if lead:
            log(f"resumed from step {start}")
    step_fn = make_train_step(cfg, ocfg, data=data, shards=shards,
                              model=model, slices=slices)
    # as in the reference, a resumed run packs from the first document
    # again, not from the batch the interrupted run stopped at
    stream = batches if batches is not None else corpus_stream(
        cfg, batch, seq, dev)
    ck = AsyncCheckpointer()
    history = []
    for step in range(start, steps):
        t0 = device_clock(dev)
        hb = rows_of(next(stream), data)
        tensors = {k: torch.as_tensor(v, device=dev) for k, v in hb.items()}
        t_pack = device_clock(dev) - t0
        times: Dict[str, float] = {}
        grads: Optional[Dict] = {} if on_step is not None else None
        net, opt, metr = step_fn(net, opt, tensors, times=times,
                                 grads_out=grads)
        rec = dict(step=step, loss=float(metr["loss"]),
                   gnorm=float(metr["gnorm"]), lr=float(metr["lr"]),
                   t_pack=t_pack, t_grad=times["grad"],
                   t_update=times["update"])
        if data is not None:
            rec.update(t_reduce=times["reduce"], t_gather=times["gather"],
                       reduce_bytes=metr["reduce_bytes"],
                       gather_bytes=metr["gather_bytes"])
        if model is not None:
            rec.update(t_model=times["model"],
                       model_bytes=metr["model_bytes"],
                       model_bytes_by_kind=metr["model_bytes_by_kind"],
                       t_model_by_kind=metr["model_s_by_kind"])
        history.append(rec)
        if on_step is not None:
            on_step(step, net, grads, metr)
        del grads
        if lead and (step % 5 == 0 or step == steps - 1):
            log(f"step {step:4d} loss={rec['loss']:.4f} "
                f"gnorm={rec['gnorm']:.2f}")
        if ckpt and (step + 1) % ckpt_every == 0:
            if whole:
                ck.save_async(ckpt, step + 1, {"params": net, "opt": opt})
            else:
                save_sharded(ckpt, step + 1, net, opt, ocfg, shards, data,
                             model=model, slices=slices)
    ck.wait()
    if lead:
        log("done")
    return {"model": net, "opt": opt, "start": start, "history": history}


def _train_rank(comm, arch: str, smoke: bool, d: int, m: int, kw: Dict
                ) -> list:
    """One rank of ``main``'s world of ``d x m`` ranks: ``train`` on its
    data index's rows with its slices; returns its history."""
    cfg = get_smoke(arch) if smoke else get_config(arch)
    mesh = make_mesh(comm, d, m)
    return train(cfg, data=mesh.data, model=mesh.model, device=comm.device,
                 **kw)["history"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--mesh", default="1x1",
                    help="DxM data x model (M = 1: D data-parallel ranks)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="ckpts_launch")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    d, m = (int(x) for x in args.mesh.split("x"))
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    # an uneven split of a leaf on "model" raises before any rank starts
    model_slices(cfg, train_rules(cfg, m), m, 0)
    kw = dict(steps=args.steps, batch=args.batch, seq=args.seq, lr=args.lr,
              ckpt=args.ckpt, ckpt_every=args.ckpt_every)
    if d * m == 1:
        return train(cfg, device=args.device, **kw)
    from ..distributed import run_world
    dev = resolve_device(args.device)
    devices = ([str(dev)] * d * m if dev.type == "cpu"
               else ["cuda:0"] * d * m)
    with tempfile.TemporaryDirectory() as tmp:
        return run_world(_train_rank, d * m, args.arch, args.smoke, d, m, kw,
                         init_file=os.path.join(tmp, "rendezvous"),
                         devices=devices, timeout_s=600.0,
                         join_s=WORLD_S)


if __name__ == "__main__":
    main()
