"""Batched LM serving on the PyTorch/CUDA port: prefill + lockstep decode
with KV caches (MLA's latent caches, an SSD block's constant-size state).

    PYTHONPATH=src python examples/serve_lm_torch.py               # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu  # the host
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu --arch jamba-v0.1-52b

The port's copy of ``examples/serve_lm.py``, on the smoke-size config of
``--arch`` (Qwen2-7B by default; any architecture whose requests are
tokens alone, the MoE, MLA and SSM ones included).  Weights are random,
drawn from a seeded generator.
"""
import argparse

import numpy as np

from repro_torch.configs.base import get_smoke_config, list_archs
from repro_torch.models.model import count_params, init_params
from repro_torch.serve.engine import Engine

# The architectures served from tokens alone (no image or audio stub).
ARCHS = [a for a in list_archs() if get_smoke_config(a).family not in ("vlm", "audio")]


def main(device: str = "cuda", arch: str = "qwen2-7b"):
    cfg = get_smoke_config(arch)
    params = init_params(cfg, seed=0, device=device)
    print(f"{cfg.name}: {count_params(cfg):,} parameters on {device}")
    engine = Engine(cfg, params, temperature=0.8, seed=1)

    rng = np.random.default_rng(0)
    requests = {"tokens": rng.integers(0, cfg.vocab_size, (4, 12), dtype=np.int32)}
    out = engine.generate(requests, max_new_tokens=16)
    for i, row in enumerate(out):
        print(f"request {i}: prompt(12 tok) → generated {row.tolist()}")

    greedy = Engine(cfg, params, temperature=0.0)
    a = greedy.generate(requests, max_new_tokens=8)
    b = greedy.generate(requests, max_new_tokens=8)
    assert (a == b).all()
    print("greedy decode deterministic ✓")


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    ap.add_argument("--arch", default="qwen2-7b", choices=ARCHS,
                    help="the architecture whose smoke config is served")
    args = ap.parse_args()
    main(args.device, args.arch)
