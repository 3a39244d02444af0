"""Variational quantum circuit classifier: encoder → hardware-efficient
ansatz → ⟨Z⟩ readout → logits.

Counterpart of ``qfedx_tpu/models/vqc.py`` (``make_vqc_classifier``'s
three encodings — ``angle`` (one RY(π·f) per qubit), ``amplitude``
(2^n features as the state's amplitudes) and ``reupload`` (the
data-reuploading circuit, BASELINE.md config 4) — in
``init``/``apply``/``apply_clients``/``wrap_delta``/``name``), with the
reference's routing:

- **batched** (``batched_enabled(n)``: the slab widths n ≥ 10 with
  QFEDX_BATCHED on, and no remat): the batch folded into slab rows — the
  log-depth product state on the scan route, the HEA as one stacked
  fused program (the scan-body kernel on the card, differentiable
  through ``ops/scan_body.ScanBodyFn``), ``expect_z_all_b``, the affine
  readout. ``apply_clients`` is its client-folded twin (**folded**): C
  clients' samples as one (C·B, 2^n) slab with per-client coefficient
  groups.
- **vmap** (otherwise: below n = 10, under QFEDX_BATCHED=0, or with
  ``remat``): the dense engine on a (B, 2, …, 2) state — ``angle_encode``,
  ``hardware_efficient`` (gate by gate below the slab widths; fused or
  scanned above them, where the dense state runs as its slab), then
  ``z_logits``. The reference vmaps one sample's forward; here the
  sample axis is a leading state axis, and ``apply_clients`` on
  (C, B, n) features with (C, …) parameters broadcasts the client axis
  in front of it — the reference's ``jax.vmap(apply)``.

The reupload circuit scans its L − 1 [bank + layer] blocks (layer 0
encodes |0…0⟩ alone), so its scan route engages one layer shallower
(``_scan_on``). Not ported yet: noise (so ``apply_train`` is None).

``params_from_jax`` (``models/api.py``) carries the reference's
parameter pytree across (``enc_w``/``enc_b`` too), shared (L, n) or
client-stacked (C, L, n) alike.
"""

from __future__ import annotations

import math

import torch

from qfedx_tpu_torch.circuits.ansatz import (
    data_reuploading,
    data_reuploading_b,
    hardware_efficient,
    hardware_efficient_b,
    init_ansatz_params,
    init_reuploading_params,
)
from qfedx_tpu_torch.circuits.encoders import (
    amplitude_encode,
    angle_amplitudes,
    angle_encode,
)
from qfedx_tpu_torch.circuits.readout import init_readout_params, z_logits
from qfedx_tpu_torch.models.api import (  # noqa: F401 — re-exported
    Model,
    params_from_jax,
)
from qfedx_tpu_torch.ops import fuse
from qfedx_tpu_torch.ops.cpx import state_dtype
from qfedx_tpu_torch.ops.batched import (
    batched_enabled,
    bstate_amplitude,
    bstate_product,
    bstate_product_tree,
    expect_z_all_b,
)
from qfedx_tpu_torch.utils import pins

# Parameter leaves that are rotation angles (periodic in 2π). Readout
# scale/bias are ordinary affine parameters and are not wrapped.
_ANGLE_LEAVES = frozenset({"rx", "rz", "enc_b"})


def wrap_angle(x: torch.Tensor) -> torch.Tensor:
    """Wrap to [−π, π): (x + π) mod 2π − π (``torch.remainder`` has the
    floor semantics of ``jnp.mod``)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


def wrap_delta(delta: dict) -> dict:
    """Angle leaves of a parameter update wrapped to [−π, π); the readout
    passes through."""
    return {
        "ansatz": {
            k: (wrap_angle(v) if k in _ANGLE_LEAVES else v)
            for k, v in delta["ansatz"].items()
        },
        "readout": delta["readout"],
    }


def make_vqc_classifier(
    n_qubits: int,
    n_layers: int = 2,
    num_classes: int = 2,
    encoding: str = "angle",
    basis: str = "ry",
    init_scale: float = 0.1,
    remat: bool = False,
    device=None,
) -> Model:
    """Build the VQC classifier Model. Input features: (B, n_qubits) in
    [0,1] for the angle and reupload encodings, (B, 2^n_qubits) for
    amplitude. ``remat`` checkpoints each ansatz layer (the dense route).
    ``device=None`` means the card and raises without one."""
    if num_classes > n_qubits:
        raise ValueError(f"need n_qubits ≥ num_classes ({num_classes})")
    if encoding not in ("angle", "amplitude", "reupload"):
        raise ValueError(f"unknown encoding {encoding!r}")
    if encoding == "angle" and basis == "rz":
        import warnings

        # RZ(θ)|0⟩ is a global phase: the features never reach the circuit.
        warnings.warn(
            "basis='rz' angle encoding produces a global phase only — the "
            "features are invisible to the circuit; use 'ry' or 'rx'",
            UserWarning,
            stacklevel=2,
        )
    dev = pins.resolve_device(device)

    def init(seed) -> dict:
        """Parameters on the model's device; ``seed`` as in
        ``circuits.ansatz.init_ansatz_params``."""
        init_fn = (init_reuploading_params if encoding == "reupload"
                   else init_ansatz_params)
        return {
            "ansatz": init_fn(seed, n_qubits, n_layers, init_scale, dev),
            "readout": init_readout_params(num_classes, dev),
        }

    def engine() -> str:
        """The engine ``apply`` runs now (pins are read at every call):
        "batched" or "vmap"; ``apply_clients`` runs "folded" in place of
        "batched"."""
        if remat or not batched_enabled(n_qubits):
            return "vmap"
        return "batched"

    def _scan_on() -> bool:
        # Reupload scans its L − 1 [bank + layer] blocks (layer 0 encodes
        # |0…0⟩ alone), so its route gates one layer shallower.
        eff = n_layers - 1 if encoding == "reupload" else n_layers
        return fuse.scan_active(n_qubits, eff)

    def _forward_b(a, x):
        """(B, feat) features → (B, 2^n) slab (a: shared or per-client
        ansatz parameters over the client-major rows)."""
        if encoding == "reupload":
            return data_reuploading_b(x, a)
        if encoding == "amplitude":
            state = bstate_amplitude(x, state_dtype())
        else:
            # The scan route pairs with the log-depth product state;
            # scan-off keeps the sequential encoder, as the reference.
            enc_fn = bstate_product_tree if _scan_on() else bstate_product
            state = enc_fn(angle_amplitudes(x * math.pi, basis))
        return hardware_efficient_b(state, n_qubits, a)

    def _features(params, x):
        return torch.as_tensor(x, dtype=torch.float32,
                               device=params["ansatz"]["rx"].device)

    def _apply_dense(params, x):
        """(*lead, feat) features with (*g, …) parameters, g a prefix of
        lead → (*lead, k) logits through the dense engine."""
        a = params["ansatz"]
        if encoding == "reupload":
            state = data_reuploading(x, a, remat=remat)
        else:
            enc = (angle_encode(x, basis) if encoding == "angle"
                   else amplitude_encode(x))
            state = hardware_efficient(enc, n_qubits, a, remat=remat)
        return z_logits(state, params["readout"], n_qubits)

    def apply(params: dict, x) -> torch.Tensor:
        x = _features(params, x)
        if engine() == "vmap":
            return _apply_dense(params, x)
        state = _forward_b(params["ansatz"], x)
        k = params["readout"]["scale"].shape[0]
        z = expect_z_all_b(state, n_qubits)[:, :k]
        return params["readout"]["scale"] * z + params["readout"]["bias"]

    def apply_clients(cparams: dict, x) -> torch.Tensor:
        """Per-client forward: params leaves (C, …), x (C, B, n) → logits
        (C, B, k). Batched: the C clients' states run as ONE (C·B, 2^n)
        slab with per-client grouped gate coefficients; vmap: the client
        axis leads the dense state's batch axis."""
        x = _features(cparams, x)
        if engine() == "vmap":
            return _apply_dense(cparams, x)
        c, bsz = x.shape[0], x.shape[1]
        state = _forward_b(cparams["ansatz"],
                           x.reshape((c * bsz,) + tuple(x.shape[2:])))
        k = cparams["readout"]["scale"].shape[-1]
        z = expect_z_all_b(state, n_qubits)[:, :k].reshape(c, bsz, k)
        return (
            cparams["readout"]["scale"][:, None, :] * z
            + cparams["readout"]["bias"][:, None, :]
        )

    return Model(
        init=init,
        apply=apply,
        wrap_delta=wrap_delta,
        apply_train=None,
        apply_clients=apply_clients,
        name=f"vqc{n_qubits}q{n_layers}l-{encoding}",
        engine=engine,
    )
