"""Training launcher.  Counterpart of ``repro/launch/train.py``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b \\
        --smoke --device cpu --steps 8 --batch 4 --seq 128

Builds the model (random weights from a seed), AdamW with a warmup of
``max(steps // 10, 1)`` and a cosine over ``steps``, and trains on
balanced-packed batches of a synthetic corpus (``SyntheticCorpus(vocab,
seed=1).documents(2048)`` through ``pack_batches``, whose balancer runs
on the training device), with an async checkpoint every
``--ckpt-every`` steps and resume from the newest step under ``--ckpt``.
Runs on CUDA unless ``--device cpu``.  One device only: ``--mesh``
takes ``1x1`` (data-parallel and sharded training are ROADMAP.md's
multi-rank training item, queue 1, item 14).

``train(cfg, ...)`` is the loop; ``main`` parses the arguments and calls
it, and ``chip_smoke.py`` calls it with a config whose depth is cut.
"""
from __future__ import annotations

import argparse
from typing import Callable, Dict, Iterator, Optional

import torch

from ..configs import get_config, get_smoke
from ..data import SyntheticCorpus, pack_batches
from ..device import resolve_device
from ..models import ModelConfig, init_model
from ..train import (AdamWConfig, AsyncCheckpointer, init_opt_state,
                     latest_step, make_train_step, restore)
from ..train.train_step import device_clock

MULTI_RANK = ("only --mesh 1x1 runs: data-parallel and sharded training "
              "are the multi-rank training item of ROADMAP.md (queue 1, "
              "item 14)")


def corpus_stream(cfg: ModelConfig, batch: int, seq: int, device
                  ) -> Iterator[Dict]:
    """Packed batches of the synthetic corpus, endlessly: the 2,048
    documents again from the first once they run out."""
    docs = SyntheticCorpus(vocab=cfg.vocab, seed=1).documents(2048)
    while True:
        yield from pack_batches(docs, batch, seq, vocab=cfg.vocab,
                                device=device)


def train(cfg: ModelConfig, *, steps: int = 20, batch: int = 8,
          seq: int = 256, lr: float = 3e-4,
          ckpt: Optional[str] = "ckpts_launch", ckpt_every: int = 10,
          device=None, batches: Optional[Iterator] = None,
          log: Callable = print) -> Dict:
    """Train ``cfg`` for ``steps`` steps (from the newest checkpoint under
    ``ckpt``, if any; ``ckpt=None`` neither reads nor writes any).
    ``batches`` replaces the corpus stream (an iterator of dicts of
    numpy arrays).  Returns ``{"model", "opt", "start", "history"}``:
    ``history`` holds a dict a step taken -- ``step``, ``loss``,
    ``gnorm``, ``lr`` and the seconds of packing (``t_pack``: the next
    batch packed and copied to the device), forward + backward
    (``t_grad``) and update (``t_update``), each with the device
    synchronized."""
    dev = resolve_device(device)
    ocfg = AdamWConfig(lr=lr, warmup=max(steps // 10, 1), total_steps=steps)
    log(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M device={dev}")
    model = init_model(cfg, seed=0, device=dev)
    opt = init_opt_state(model, ocfg)
    start = 0
    if ckpt and latest_step(ckpt) is not None:
        start, state = restore(ckpt, template={"params": model, "opt": opt})
        opt = state["opt"]
        log(f"resumed from step {start}")
    step_fn = make_train_step(cfg, ocfg)
    # as in the reference, a resumed run packs from the first document
    # again, not from the batch the interrupted run stopped at
    stream = batches if batches is not None else corpus_stream(
        cfg, batch, seq, dev)
    ck = AsyncCheckpointer()
    history = []
    for step in range(start, steps):
        t0 = device_clock(dev)
        hb = next(stream)
        tensors = {k: torch.as_tensor(v, device=dev) for k, v in hb.items()}
        t_pack = device_clock(dev) - t0
        times: Dict[str, float] = {}
        model, opt, metr = step_fn(model, opt, tensors, times=times)
        rec = dict(step=step, loss=float(metr["loss"]),
                   gnorm=float(metr["gnorm"]), lr=float(metr["lr"]),
                   t_pack=t_pack, t_grad=times["grad"],
                   t_update=times["update"])
        history.append(rec)
        if step % 5 == 0 or step == steps - 1:
            log(f"step {step:4d} loss={rec['loss']:.4f} "
                f"gnorm={rec['gnorm']:.2f}")
        if ckpt and (step + 1) % ckpt_every == 0:
            ck.save_async(ckpt, step + 1, {"params": model, "opt": opt})
    ck.wait()
    log("done")
    return {"model": model, "opt": opt, "start": start, "history": history}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--mesh", default="1x1", help="DxM data x model (1x1)")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default="ckpts_launch")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)
    if args.mesh != "1x1":
        raise ValueError(f"--mesh {args.mesh}: {MULTI_RANK}")
    cfg = get_smoke(args.arch) if args.smoke else get_config(args.arch)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, ckpt=args.ckpt, ckpt_every=args.ckpt_every,
                 device=args.device)


if __name__ == "__main__":
    main()
