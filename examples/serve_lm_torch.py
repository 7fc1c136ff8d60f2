"""Batched LM serving on the PyTorch/CUDA port: prefill + lockstep decode
with KV caches.

    PYTHONPATH=src python examples/serve_lm_torch.py               # the card
    PYTHONPATH=src python examples/serve_lm_torch.py --device cpu  # the host

The port's copy of ``examples/serve_lm.py``, on the smoke-size Qwen2-7B.
Weights are random, drawn from a seeded generator.
"""
import argparse

import numpy as np

from repro_torch.configs.base import get_smoke_config
from repro_torch.models.model import count_params, init_params
from repro_torch.serve.engine import Engine


def main(device: str = "cuda"):
    cfg = get_smoke_config("qwen2-7b")
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
    main(ap.parse_args().device)
