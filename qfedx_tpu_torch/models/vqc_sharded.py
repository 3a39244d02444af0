"""VQC classifier on the slot-sharded statevector engine.

Counterpart of ``qfedx_tpu/models/vqc_sharded.py``: the parameter dict,
circuit and readout of ``models/vqc.py`` (hardware-efficient ansatz,
⟨Z⟩ → logit), with the forward on a state sharded over an sv group of
``sv_size`` slots (``parallel/sharded.py``) — the model for widths past
one device's dense ceiling (BASELINE.md config 5).

``apply`` runs on the slots ``parallel.sharded.sv_group`` names and
raises outside one; where the group spans processes each member runs
it on the same inputs and ``parallel.sharded.pmean_grad`` makes the
gradients exact, as the reference's does. ``fed/round.make_fed_round``
over a 2-D (clients, sv) mesh sets each client slot's group around its
block, so the round runs data parallelism (clients) × state
parallelism (sv); evaluation and serving wrap the model with
``host_apply(model, mesh)``. A sample's
state spans the whole group, so samples batch as leading axes of every
shard. The model has no ``apply_clients`` (the exchange choreography
has no client-folded form), so the round takes its per-client path.

Noise (``noise_model``) as the dense model: the analytic maps in
``apply``; ``apply_train(params, x, draws)`` under circuit-level
channels (trajectories, branches from ``draws["branch_gumbel"]``) or
finite shots (``draws["shot_uniform"]``; the state then runs without
autograd).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from qfedx_tpu_torch.circuits.ansatz import init_ansatz_params
from qfedx_tpu_torch.circuits.readout import init_readout_params
from qfedx_tpu_torch.models.api import Model, StepDraw
from qfedx_tpu_torch.models.vqc import wrap_delta
from qfedx_tpu_torch.noise.trajectory import MAX_BRANCHES
from qfedx_tpu_torch.parallel.circuit import sharded_hea_state
from qfedx_tpu_torch.parallel.sharded import (
    current_group,
    expect_z_all_sharded,
    pmean_grad,
    shard_ctx,
    sv_group,
)
from qfedx_tpu_torch.utils import pins, trees


def make_sharded_vqc_classifier(
    n_qubits: int,
    sv_size: int,
    n_layers: int = 2,
    num_classes: int = 2,
    sv_axis: str = "sv",
    init_scale: float = 0.1,
    encoding: str = "angle",
    noise_model=None,
    device=None,
) -> Model:
    """VQC Model on an ``sv_size``-way sharded state: a power of two
    leaving ≥ 2 local qubits; ``encoding`` "angle" (n features) or
    "amplitude" (2^n). ``device`` (None = the card) holds ``init``'s
    parameters; the forward runs on the sv group's slots."""
    if num_classes > n_qubits:
        raise ValueError(f"need n_qubits ≥ num_classes ({num_classes})")
    if encoding not in ("angle", "amplitude"):
        raise ValueError(f"sharded VQC supports angle/amplitude, got {encoding!r}")
    n_global = (sv_size - 1).bit_length()
    if 1 << n_global != sv_size:
        raise ValueError(f"sv_size {sv_size} is not a power of two")
    if n_qubits - n_global < 2:
        raise ValueError("need ≥2 local qubits for sharded 2q gates")
    dev = pins.resolve_device(device)
    name = f"svqc{n_qubits}q{n_layers}l-{encoding}-sv{sv_size}"
    channels = tuple(noise_model.kraus_channels(dev)
                     if noise_model is not None else ())
    circuit_noise = (noise_model is not None and noise_model.circuit_level
                     and len(channels) > 0)
    # The dense model's evaluation convention: exact expectation, on
    # the layer-composed strengths under circuit placement.
    eval_noise = None
    if noise_model is not None:
        eval_noise = noise_model.exact_shots()
        if circuit_noise:
            eval_noise = eval_noise.composed(n_layers)

    def init(seed) -> dict:
        return {
            "ansatz": init_ansatz_params(seed, n_qubits, n_layers,
                                         init_scale, dev),
            "readout": init_readout_params(num_classes, dev),
        }

    def _ctx():
        group = current_group()
        if group is None:
            raise ValueError(
                f"model {name} is sv-sharded; its apply runs on an sv "
                "group: wrap it with host_apply(model, mesh) or train it "
                "through a mesh round"
            )
        if len(group) != sv_size:
            raise ValueError(f"model {name} needs an sv group of {sv_size} "
                             f"slots, got {len(group)}")
        return shard_ctx(sv_axis, n_qubits, n_global, group)

    def _logits(params, x, nm, shot_u=None, chans=(), gumbel=None,
                grad=True):
        ctx = _ctx()
        home = ctx.home
        # Gradient correctness across processes: see pmean_grad (the
        # identity inside one process).
        params = pmean_grad(trees.tree_map(lambda p: p.to(home), params),
                            ctx)
        x = torch.as_tensor(x, dtype=torch.float32, device=home)
        with torch.set_grad_enabled(torch.is_grad_enabled() and grad):
            state = sharded_hea_state(ctx, x, params["ansatz"], encoding,
                                      chans, gumbel)
            z = expect_z_all_sharded(ctx, state)[..., :num_classes]
        if nm is not None:
            # z is the sum over the slots: the analytic maps and the
            # shot counts act on it once.
            z = nm.apply_to_z(z, shot_u)
        return params["readout"]["scale"] * z + params["readout"]["bias"]

    def apply(params: dict, x) -> torch.Tensor:
        return _logits(params, x, eval_noise)

    apply_train = None
    train_draws = ()
    if circuit_noise or (noise_model is not None
                         and noise_model.shots is not None):
        # Channels already acted in the circuit: readout keeps confusion
        # and shots.
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
            gumbel = None
            if circuit_noise:
                gumbel = torch.as_tensor(draws["branch_gumbel"],
                                         device=_ctx().home)
            # Shot counts carry no gradient: with shots only the
            # readout reaches the loss.
            return _logits(params, x, readout_noise,
                           draws.get("shot_uniform"),
                           channels if circuit_noise else (), gumbel,
                           grad=not shots)

    return Model(
        init=init,
        apply=apply,
        wrap_delta=wrap_delta,
        apply_train=apply_train,
        train_draws=train_draws,
        apply_clients=None,
        name=name,
        engine=lambda: "sharded",
        sv_size=sv_size,
        sv_axis=sv_axis,
    )


def host_apply(model: Model, mesh, sv_axis: str = "sv"):
    """``(params, x) -> logits`` for a sharded model, callable anywhere:
    the forward runs on the first of the mesh's sv groups that this
    process is a member of, in lockstep with the group's other members,
    which call it on the same inputs (every rank builds it: the groups'
    process subgroups are made here). Evaluation (``fed/evaluate.
    make_evaluator(apply_fn=)``) and serving (``ServeEngine(apply_fn=)``)
    take it."""
    from qfedx_tpu_torch.parallel.mesh import is_member, sv_process_groups

    groups = mesh.sv_groups(sv_axis)
    sv_process_groups(groups)
    mine = [g for g in groups if is_member(g)]
    if not mine:
        raise ValueError("this process holds no slot of the mesh's sv "
                         "groups")
    group = mine[0]

    def wrapped(params, x):
        with sv_group(group):
            return model.apply(params, x)

    return wrapped


def fed_mesh_2d(num_client_devices: int, sv_size: int, devices=None):
    """(clients, sv) mesh over a slot subset — ``parallel.mesh.fed_mesh``
    (one mesh constructor, one placement policy)."""
    from qfedx_tpu_torch.parallel.mesh import fed_mesh

    return fed_mesh(sv_size=sv_size, num_client_devices=num_client_devices,
                    devices=devices)
