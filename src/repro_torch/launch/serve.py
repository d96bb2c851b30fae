"""Serving launcher, the port of `repro/launch/serve.py`: --arch <id>,
a batch of random requests through ServeEngine.

    python -m repro_torch.launch.serve --arch llama3-8b            # card
    python -m repro_torch.launch.serve --arch llama3-8b --reduced \\
        --device cpu                                             # host

`--reduced` takes the config's small same-topology variant in float32;
without it the full config runs at its own dtype, with random weights
made on the device from a seeded generator.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from ..configs import get_config
from ..kernels import common
from ..models import init_params
from ..serve import ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
    if cfg.input_mode != "tokens":
        raise SystemExit(f"{cfg.name} takes embedding inputs; the text "
                         "serving demo needs a token arch")
    device = common.resolve_device(args.device)
    params = init_params(cfg, 0, device=device)
    max_len = args.prompt_len + args.new_tokens + 1
    engine = ServeEngine(cfg, params, max_len=max_len,
                         batch_size=args.batch,
                         temperature=args.temperature, device=device)
    gen = torch.Generator(device=device).manual_seed(1)
    prompts = torch.randint(0, cfg.vocab_size,
                            (args.batch, args.prompt_len), generator=gen,
                            device=device, dtype=torch.int32)
    t0 = time.time()
    res = engine.generate(prompts, max_new_tokens=args.new_tokens)
    dt = time.time() - t0
    print(f"generated {res.steps} tokens x {args.batch} seqs in "
          f"{dt:.2f}s ({args.batch * res.steps / dt:.1f} tok/s) on "
          f"{device}")
    for i, row in enumerate(res.tokens[:4]):
        print(f"  seq{i}: {row[:12]}...")


if __name__ == "__main__":
    main()
