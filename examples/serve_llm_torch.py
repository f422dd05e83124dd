"""Batched serving of an LLM on the PyTorch port: prefill + greedy decode.

The port's counterpart of ``examples/serve_llm.py``: ring KV caches (and
Mamba states for the SSM and hybrid archs), greedy sampling, random
weights from a seed.  ``--arch`` takes any registered config (dense,
MoE, SSM, hybrid, the VLM and the enc-dec); the stubbed frontends get
seeded embeddings, as in the reference: 256 patch embeddings for
PaliGemma, 1500 audio frames for Whisper (16 and 64 at ``--reduced``).
It runs on the card at full width unless asked otherwise; prompts or
caches longer than 8192 tokens take the hand-written flash-attention
kernel::

    python examples/serve_llm_torch.py --prompt-len 16384 --gen 32 --batch 4
    python examples/serve_llm_torch.py --arch qwen3-moe-30b-a3b --batch 1 --prompt-len 16384
    python examples/serve_llm_torch.py --device cpu --reduced --prompt-len 48 --gen 16
    python examples/serve_llm_torch.py --device cpu --reduced --arch jamba-v0.1-52b
    python examples/serve_llm_torch.py --device cpu --reduced --arch whisper-tiny
    python examples/serve_llm_torch.py --device cpu --reduced --arch paligemma-3b
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.launch.serve import make_decode_step, make_prefill_step  # noqa: E402


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=list(ARCH_IDS))
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--reduced", action="store_true",
                    help="the config's CPU-sized variant (2 layers, width 256)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    arch = get_arch(args.arch, reduced=args.reduced)
    cfg = arch.cfg
    params = arch.init(seed=0, device=dev)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, cfg.vocab_size, size=(args.batch, args.prompt_len))
    batch = {"tokens": torch.from_numpy(tokens.astype(np.int64)).to(dev)}
    if cfg.frontend == "vision":
        batch["embeds"] = torch.from_numpy(
            rng.randn(args.batch, cfg.num_frontend_tokens, cfg.d_model)
            .astype(np.float32) * 0.02).to(device=dev, dtype=cfg.torch_dtype)
    if cfg.frontend == "audio":
        batch["embeds"] = torch.from_numpy(
            rng.randn(args.batch, cfg.encoder_seq, cfg.d_model)
            .astype(np.float32) * 0.02).to(device=dev, dtype=cfg.torch_dtype)

    capacity = args.prompt_len + args.gen + 8
    prefill = make_prefill_step(arch, capacity=capacity)
    decode = make_decode_step(arch)

    flash0 = obs.totals()["flash.launches"]
    _sync(dev)
    t0 = time.perf_counter()
    token, caches = prefill(params, batch)
    _sync(dev)
    dt_prefill = time.perf_counter() - t0
    print(f"{cfg.name} ({cfg.num_layers} layers, {cfg.dtype}) on {dev}: "
          f"prefill({args.batch}×{args.prompt_len}) → first tokens "
          f"{token.tolist()}  ({dt_prefill:.3f} s, "
          f"{args.batch * args.prompt_len / dt_prefill:.1f} prompt tokens/s)")

    toks = [token]
    pos = args.prompt_len
    t0 = time.perf_counter()
    for i in range(args.gen):
        token, caches = decode(params, token.reshape(args.batch, 1), caches,
                               pos + i)
        toks.append(token.reshape(args.batch))
    _sync(dev)
    dt = (time.perf_counter() - t0) / max(args.gen, 1)
    gen = torch.stack(toks, dim=1).cpu().numpy()
    print(f"generated {args.gen} tokens/seq at {dt * 1e3:.3f} ms/token; "
          f"flash-attention kernel launches {obs.totals()['flash.launches'] - flash0}")
    for b in range(args.batch):
        print(f"  seq{b}: {gen[b].tolist()}")


if __name__ == "__main__":
    main()
