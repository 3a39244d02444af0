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
(``_scan_on``).

**Noise** (``noise_model``, a ``noise.NoiseModel``), on the reference's
routes: any noise turns the batched engine off, so ``engine()`` is
"vmap" (the dense engine; at the slab widths its slab, and the scan-body
kernel where the scan takes the program).

- ``apply``/``apply_clients`` read the logits through ``eval_noise``:
  the model without shots (``exact_shots``), on the L-layer composed
  strengths under circuit placement.
- ``apply_train(params, x, draws)`` exists with finite shots or with
  circuit-level channels. Readout placement: the noiseless state, the
  analytic maps, then counts from ``draws["shot_uniform"]`` (one U[0, 1)
  per (sample, class)). The counts carry no gradient, as in the
  reference, so the state runs without autograd (Launch A on the card)
  and only the readout learns. Circuit placement: the trajectory
  forward (``noisy_forward_state``) — per layer the ansatz layer, then
  every Kraus channel on every qubit with its branch from
  ``draws["branch_gumbel"]`` ((B, L, channels, n, 4) Gumbel draws; a
  channel of k branches reads the first k): the channels are barriers
  to the scan and to fusion across layers, so no kernel runs; then
  confusion and shots only.
- Circuit placement with the reupload encoding raises ValueError.

``params_from_jax`` (``models/api.py``) carries the reference's
parameter pytree across (``enc_w``/``enc_b`` too), shared (L, n) or
client-stacked (C, L, n) alike.
"""

from __future__ import annotations

import math
from dataclasses import replace

import torch
from torch.utils.checkpoint import checkpoint

from qfedx_tpu_torch import obs
from qfedx_tpu_torch.circuits.ansatz import (
    ansatz_layer,
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
    StepDraw,
    params_from_jax,
)
from qfedx_tpu_torch.noise.trajectory import MAX_BRANCHES, apply_channel_all
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
    noise_model=None,
) -> Model:
    """Build the VQC classifier Model. Input features: (B, n_qubits) in
    [0,1] for the angle and reupload encodings, (B, 2^n_qubits) for
    amplitude. ``remat`` checkpoints each ansatz layer (the dense route).
    ``noise_model``: an optional ``noise.NoiseModel`` between circuit and
    readout. ``device=None`` means the card and raises without one."""
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
    channels = ([] if noise_model is None
                else noise_model.kraus_channels(dev))
    circuit_noise = (noise_model is not None and noise_model.circuit_level
                     and len(channels) > 0)
    if circuit_noise and encoding == "reupload":
        raise ValueError("circuit-level noise supports angle/amplitude "
                         "encodings")
    # The deterministic forward's noise: no shots (apply carries no
    # draws), and under circuit placement the L-layer composed strengths,
    # so evaluation tracks the channel the model trained under.
    eval_noise = None
    if noise_model is not None:
        eval_noise = noise_model.exact_shots()
        if circuit_noise:
            eval_noise = eval_noise.composed(n_layers)

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
        if noise_model is not None or remat or not batched_enabled(n_qubits):
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

    def _encode(x):
        return (angle_encode(x, basis) if encoding == "angle"
                else amplitude_encode(x))

    def _state_dense(params, x):
        a = params["ansatz"]
        if encoding == "reupload":
            return data_reuploading(x, a, remat=remat)
        return hardware_efficient(_encode(x), n_qubits, a, remat=remat)

    def _apply_dense(params, x):
        """(*lead, feat) features with (*g, …) parameters, g a prefix of
        lead → (*lead, k) logits through the dense engine."""
        state = _state_dense(params, x)
        if eval_noise is not None:
            return eval_noise.noisy_logits(state, params["readout"],
                                           n=n_qubits)
        return z_logits(state, params["readout"], n_qubits)

    # engine.trace times the program build and run of each engine route;
    # the reference's fires once per trace, this one at every call.
    def apply(params: dict, x) -> torch.Tensor:
        x = _features(params, x)
        if engine() == "vmap":
            with obs.span("engine.trace", engine="vmap", n_qubits=n_qubits,
                          scan=_scan_on() and not remat):
                return _apply_dense(params, x)
        with obs.span("engine.trace", engine="batched", n_qubits=n_qubits,
                      scan=_scan_on()):
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
            with obs.span("engine.trace", engine="vmap", n_qubits=n_qubits,
                          scan=_scan_on() and not remat):
                return _apply_dense(cparams, x)
        with obs.span("engine.trace", engine="folded", n_qubits=n_qubits,
                      scan=_scan_on()):
            c, bsz = x.shape[0], x.shape[1]
            state = _forward_b(cparams["ansatz"],
                               x.reshape((c * bsz,) + tuple(x.shape[2:])))
            k = cparams["readout"]["scale"].shape[-1]
            z = expect_z_all_b(state, n_qubits)[:, :k].reshape(c, bsz, k)
            return (
                cparams["readout"]["scale"][:, None, :] * z
                + cparams["readout"]["bias"][:, None, :]
            )

    def noisy_forward_state(params, x, gumbel):
        """The trajectory forward on (B, feat) features: per layer the
        ansatz layer (checkpointed under ``remat``), then every channel
        on every qubit, branches from ``gumbel`` (B, L, channels, n, 4)."""
        state = _encode(x)
        a = params["ansatz"]
        for layer in range(a["rx"].shape[-2]):
            rx, rz = a["rx"][..., layer, :], a["rz"][..., layer, :]
            if remat:
                state = checkpoint(ansatz_layer, state, n_qubits, rx, rz,
                                   use_reentrant=False)
            else:
                state = ansatz_layer(state, n_qubits, rx, rz)
            for ci, kraus in enumerate(channels):
                state = apply_channel_all(state, kraus,
                                          gumbel[:, layer, ci], n_qubits)
        return state

    apply_train = None
    train_draws = ()
    if circuit_noise or (noise_model is not None
                         and noise_model.shots is not None):
        # Under circuit placement the channels already acted on the
        # state: readout applies confusion and shots only.
        readout_noise = (replace(noise_model, depolarizing_p=0.0,
                                 amp_damping_gamma=0.0)
                         if circuit_noise else noise_model)
        shots = noise_model.shots is not None
        train_draws = ((StepDraw("shot_uniform", "uniform",
                                 (num_classes,)),) if shots else ())
        if circuit_noise:
            train_draws += (StepDraw(
                "branch_gumbel", "gumbel",
                (n_layers, len(channels), n_qubits, MAX_BRANCHES)),)

        def apply_train(params: dict, x, draws: dict) -> torch.Tensor:
            x = _features(params, x)
            # Shot counts carry no gradient, so with shots no parameter
            # but the readout's reaches the loss: the state runs without
            # autograd.
            with torch.set_grad_enabled(torch.is_grad_enabled()
                                        and not shots):
                if circuit_noise:
                    state = noisy_forward_state(
                        params, x, torch.as_tensor(draws["branch_gumbel"],
                                                   device=x.device))
                else:
                    state = _state_dense(params, x)
            return readout_noise.noisy_logits(
                state, params["readout"], draws.get("shot_uniform"),
                n=n_qubits)

    return Model(
        init=init,
        apply=apply,
        wrap_delta=wrap_delta,
        apply_train=apply_train,
        train_draws=train_draws,
        apply_clients=apply_clients,
        name=f"vqc{n_qubits}q{n_layers}l-{encoding}",
        engine=engine,
    )
