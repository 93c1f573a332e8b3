"""End-to-end training driver on the PyTorch port: LM training with
load-balanced packing, AdamW, checkpoint/restart, optional gradient
compression.

Default is a ~8M-parameter model; ``--params 100m`` selects the ~100M
configuration (same code path).  Runs on the card by default (the
packer's balancer launches the prefix-scan kernel there), on the CPU
with ``--device cpu``.

    PYTHONPATH=src python examples/torch/train_lm.py --steps 60
    PYTHONPATH=src python examples/torch/train_lm.py --steps 60 --resume
"""
import argparse
import time

import torch

from repro_torch.data import SyntheticCorpus, pack_batches
from repro_torch.models import ModelConfig, init_model
from repro_torch.train import (AdamWConfig, AsyncCheckpointer,
                               init_opt_state, latest_step, make_train_step,
                               restore)

SIZES = {
    "8m": dict(n_layers=4, d_model=256, n_heads=8, n_kv_heads=4,
               d_ff=1024, vocab=4096),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab=16384),
}


def main(argv=None, out=print):
    """Run the example; returns ``{"start", "losses"}`` (the first step
    trained and each step's loss)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--params", choices=list(SIZES), default="8m")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--ckpt", default="ckpts")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--balanced-packing", action="store_true", default=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    cfg = ModelConfig(name=f"lm-{args.params}", family="dense",
                      dtype="float32", param_dtype="float32",
                      attn_chunk=256, loss_chunk=256, remat=False,
                      **SIZES[args.params])
    ocfg = AdamWConfig(lr=3e-4, warmup=20, total_steps=args.steps)
    out(f"model: {cfg.n_params()/1e6:.1f}M params")

    model = init_model(cfg, seed=0, device=dev)
    opt = init_opt_state(model, ocfg)
    start = 0
    if args.resume and latest_step(args.ckpt) is not None:
        start, state = restore(args.ckpt,
                               template={"params": model, "opt": opt})
        opt = state["opt"]
        out(f"resumed from step {start}")

    step_fn = make_train_step(cfg, ocfg, compress=args.compress)
    comp_state = None
    if args.compress:
        from repro_torch.train import init_compress_state
        comp_state = init_compress_state(model)

    corpus = SyntheticCorpus(vocab=cfg.vocab, seed=1)
    docs = corpus.documents(4096)
    batches = pack_batches(docs, args.batch, args.seq, vocab=cfg.vocab,
                           balanced=args.balanced_packing, device=dev)
    ck = AsyncCheckpointer()
    losses = []
    t0 = time.time()
    for step in range(start, args.steps):
        try:
            batch = next(batches)
        except StopIteration:
            batches = pack_batches(docs, args.batch, args.seq,
                                   vocab=cfg.vocab,
                                   balanced=args.balanced_packing,
                                   device=dev)
            batch = next(batches)
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        if args.compress:
            model, opt, comp_state, m = step_fn(model, opt, batch,
                                                comp_state)
        else:
            model, opt, m = step_fn(model, opt, batch)
        losses.append(float(m["loss"]))
        if step % 10 == 0 or step == args.steps - 1:
            dt = time.time() - t0
            out(f"step {step:4d} loss={losses[-1]:.4f} "
                f"gnorm={float(m['gnorm']):.2f} "
                f"({dt/max(step-start+1,1):.2f}s/step)")
        if step % 25 == 24:
            ck.save_async(args.ckpt, step + 1,
                          {"params": model, "opt": opt})
    ck.wait()
    out(f"done; checkpoints in {args.ckpt}")
    return {"start": start, "losses": losses}


if __name__ == "__main__":
    main()
