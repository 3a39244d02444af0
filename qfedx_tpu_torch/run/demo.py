"""Encoder demo: the encoder walkthrough on one sample.

Counterpart of ``qfedx_tpu/run/demo.py``: load a sample → block-
downsample 28×28 → 4×4 → amplitude-encode (16 values → 4 qubits) and
print the leading |amplitude|² → pool to 4 features → angle-encode →
report the ⟨Z⟩ readout — plus a side-by-side original/downsampled PNG
(saved headless). The states are built on ``device`` (None = the card).
matplotlib is imported only for the PNG, with Agg forced; where it is
absent ``run_demo(png=True)`` raises ``ModuleNotFoundError`` after the
numbers are printed, and ``png=False`` skips the image.
"""

from __future__ import annotations

import numpy as np


def demo_numbers(dataset: str = "mnist", device=None) -> dict:
    """The walkthrough's arrays: the sample, its 4×4 downsample, the
    amplitude state's probabilities, the pooled features and the angle
    state's ⟨Z⟩, computed on ``device``."""
    import torch

    from qfedx_tpu_torch.circuits.encoders import amplitude_encode, angle_encode
    from qfedx_tpu_torch.data.datasets import load_dataset
    from qfedx_tpu_torch.data.pipeline import (
        block_downsample,
        normalize_images,
        pool_features,
    )
    from qfedx_tpu_torch.ops.statevector import expect_z_all, probabilities
    from qfedx_tpu_torch.utils import pins

    device = pins.resolve_device(device)
    _, (train_x, train_y), _ = load_dataset(dataset)
    img = normalize_images(train_x[:1])  # (1, 28, 28)
    small = block_downsample(img, 4, 4)  # (1, 4, 4)
    flat16 = small.reshape(1, 16)
    amp_state = amplitude_encode(
        torch.as_tensor(flat16[0], dtype=torch.float32, device=device))
    probs = probabilities(amp_state).cpu().numpy()
    pooled = pool_features(flat16, 4)[0]
    ang_state = angle_encode(
        torch.as_tensor(pooled, dtype=torch.float32, device=device))
    z = expect_z_all(ang_state).cpu().numpy()
    return {"img": img, "small": small, "label": int(train_y[0]),
            "probs": probs, "pooled": pooled, "z": z}


def run_demo(out_dir: str = "runs/demo", dataset: str = "mnist",
             device=None, png: bool = True) -> dict:
    from pathlib import Path

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    d = demo_numbers(dataset, device)
    img, small, label = d["img"], d["small"], d["label"]
    probs, pooled, z = d["probs"], d["pooled"], d["z"]
    print(f"[demo] sample label: {label}")
    print("[demo] amplitude encoding: 16 features -> 4 qubits")
    print(f"[demo] first 8 |amplitude|^2: {np.round(probs[:8], 5)}")
    print(f"[demo] norm check sum|a|^2 = {probs.sum():.6f}")
    print(f"[demo] angle encoding: pooled features {np.round(pooled, 4)}")
    print(f"[demo] <Z> per qubit: {np.round(z, 5)}")
    result = {
        "label": label,
        "amp_norm": float(probs.sum()),
        "z": z.tolist(),
        "png": None,
    }
    if not png:
        return result

    # Side-by-side original vs downsampled, headless.
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 2, figsize=(6, 3))
    axes[0].imshow(img[0].squeeze(), cmap="gray")
    axes[0].set_title(f"original (label {label})")
    axes[1].imshow(small[0].squeeze(), cmap="gray")
    axes[1].set_title("4x4 block-averaged")
    for ax in axes:
        ax.axis("off")
    fig.tight_layout()
    path = out / "encoding_demo.png"
    fig.savefig(path, dpi=100)
    plt.close(fig)
    print(f"[demo] comparison image: {path}")
    result["png"] = str(path)
    return result
