"""Batched naive-Bayes digit recognition on the CUDA card (serving demo):
the twin of examples/digit_serving.py on genfer_tpu_torch.

The reference's digitRecognition benchmark bakes one MNIST image into a
7863-line SGCL program and re-runs the whole interpreter per image
(reference benchmarks/neurips2023/exact/digitRecognition/, generated by
src/bin/generate_baselines.rs).  Here the *same model* is compiled once
with the per-pixel evidence probabilities as parameters, and a batch of
images is served as one replayed CUDA graph of the vmapped walk
(``genfer_tpu_torch.compile``):

    e[c, i] = x_i * theta[c, i] + (1 - x_i) * (1 - theta[c, i])

so ``observe x_i ~ Bernoulli(theta[c,i])`` becomes the structural
``observe 1 ~ Bernoulli($e_c_i)`` with the image folded into the
parameter vector — the exact class-conditional factor, computed as a
torch tensor on the card for the whole batch.

Usage:  python examples/digit_serving_torch.py [--pixels N] [--batch B]

``DATA`` names the directory of ``digitParams.csv`` (and of the optional
``digitObservations.csv``); a caller may point it elsewhere.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

DATA = Path("/root/reference/benchmarks/neurips2023/exact/digitRecognition/data")


def model_source(n_pixels: int) -> tuple[str, list[str]]:
    """The parameterized naive-Bayes SGCL program and its param order."""
    from genfer_tpu_torch.tools.generators import digit_serving_source

    return digit_serving_source(n_pixels)


def load_theta(n_pixels: int) -> np.ndarray:
    """params[digit][pixel] from the reference's committed CSV."""
    rows = []
    for line in (DATA / "digitParams.csv").read_text().strip().splitlines():
        rows.append([float(x) for x in line.split(",")[:n_pixels]])
    return np.asarray(rows)


def evidence_params(images, theta, device=None):
    """(B, n_pixels) 0/1 images -> (B, 10 * n_pixels) evidence vector, an
    f64 torch tensor on ``device`` (None: the CUDA card)."""
    import torch

    from genfer_tpu_torch.taylor.backend import _resolve_device

    dev = _resolve_device(device)
    x = torch.as_tensor(np.asarray(images, dtype=np.float64), device=dev)
    th = torch.as_tensor(np.asarray(theta, dtype=np.float64), device=dev)
    e = x[:, None, :] * th[None] + (1.0 - x[:, None, :]) * (1.0 - th[None])
    return e.reshape(x.shape[0], -1)


def main(argv=None, device=None):
    """Serve one batch; return its posteriors (B, 10) as numpy.
    ``device``: None (the CUDA card, which must exist) or ``"cpu"``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--pixels", type=int, default=784)
    ap.add_argument("--batch", type=int, default=1024)
    args = ap.parse_args(argv)

    from genfer_tpu_torch.compile import compile_program

    theta = load_theta(args.pixels)
    n_pixels = theta.shape[1]
    src, params = model_source(n_pixels)
    print(f"compiling naive-Bayes model: 10 classes x {n_pixels} pixels "
          f"({len(params)} parameters)...", file=sys.stderr)
    t0 = time.perf_counter()
    c = compile_program(src, params=params, limit=10, device=device)
    print(f"  translate: {time.perf_counter()-t0:.1f}s", file=sys.stderr)

    rng = np.random.RandomState(0)
    images = (rng.rand(args.batch, n_pixels) < 0.15).astype(np.float64)
    if (DATA / "digitObservations.csv").exists():
        obs = [int(x) for x in
               (DATA / "digitObservations.csv").read_text().strip()
               .replace("\n", ",").split(",") if x != ""][:n_pixels]
        if len(obs) == n_pixels:
            images[0] = obs
    ev = evidence_params(images, theta, c.device)

    t0 = time.perf_counter()
    out = c.probs_batch(ev).cpu().numpy()
    print(f"  first batch (warm-up walk, capture + run): "
          f"{time.perf_counter()-t0:.1f}s", file=sys.stderr)
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        out = c.probs_batch(ev).cpu().numpy()
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    post = out / out.sum(axis=1, keepdims=True)
    print(f"  steady: {args.batch} images in {best:.3f}s = "
          f"{args.batch/best:.0f} images/s", file=sys.stderr)
    print(f"  image[0] posterior: {np.array2string(post[0], precision=4)}",
          file=sys.stderr)
    print(f"  predicted digits (first 16): {post.argmax(1)[:16]}",
          file=sys.stderr)
    return post


if __name__ == "__main__":
    main()
