"""Experiment configuration: one typed schema for the full stack.

Counterpart of ``qfedx_tpu/run/config.py``: the same ``DataConfig``,
``ModelConfig`` and ``ExperimentConfig`` fields and defaults, so one
``config.json`` describes a run on either package and restores in
both (``experiment_config_from_dict``). ``build_data`` runs the port's
numpy copies of the data modules (arrays equal to the reference's bit
for bit); ``build_model`` builds the port's model on ``device`` (the
card unless a caller passes another).

``build_model`` builds every model family: the VQC at every width and
encoding (the dense engine below n = 10, the batched one above;
``remat`` passes through) with its ``NoiseModel`` when any noise flag is
on, the TinyCNN at the dataset's image shape, the MPS classifier and the
quantum-kernel head, with the reference's ValueErrors (mps with a
non-angle encoding, noise or ``sv_size > 1``; qkernel with noise). With
``sv_size > 1`` the VQC is the sv-sharded classifier
(``models/vqc_sharded.py``; angle or amplitude, no remat, as in the
reference).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any

from qfedx_tpu_torch.fed.config import DPConfig, FedConfig


@dataclass(frozen=True)
class DataConfig:
    dataset: str = "mnist"  # mnist | fashion_mnist | cifar10
    raw_folder: str | None = None  # IDX/pickle files; synthetic fallback if absent
    classes: tuple[int, ...] | None = (0, 1, 2)  # reference default digit subset
    features: str = "pca"  # image | downsample | pool | pca
    n_features: int | None = None  # defaults to n_qubits for quantum models
    val_split: float = 0.1
    num_clients: int = 4
    partition: str = "iid"  # iid | dirichlet
    alpha: float = 0.5  # Dirichlet concentration
    seed: int = 42
    # Synthetic-fallback knobs (used only when raw files are absent).
    synthetic_train: int = 4096
    synthetic_test: int = 1024
    synthetic_noise: float = 0.25


@dataclass(frozen=True)
class ModelConfig:
    model: str = "vqc"  # vqc | cnn | qkernel | mps
    n_qubits: int = 8
    n_layers: int = 2
    encoding: str = "angle"  # angle | amplitude | reupload
    init_scale: float = 0.1
    bond_dim: int = 16  # model="mps"
    sv_size: int = 1  # statevector sharding degree
    n_landmarks: int = 16  # qkernel only
    # noise; zeros = noiseless
    depolarizing_p: float = 0.0
    amp_damping_gamma: float = 0.0
    readout_flip: float = 0.0
    shots: int | None = None
    noise_placement: str = "readout"  # "readout" | "circuit"
    remat: bool = False
    # None follows the QFEDX_SCAN_LAYERS pin; True/False pin the route
    # for THIS experiment and travel with config.json, so a serve
    # restore reproduces the training-time route.
    scan_layers: bool | None = None


@dataclass(frozen=True)
class ExperimentConfig:
    data: DataConfig = field(default_factory=DataConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    fed: FedConfig = field(default_factory=FedConfig)
    num_rounds: int = 30
    eval_every: int = 1
    # Rounds run per chunk of the trainer's loop (run/trainer.py): the
    # per-round accuracy then comes from the in-chunk evaluation.
    rounds_per_call: int = 10
    pipeline_depth: int | None = None
    eval_batches: int | None = None  # cap eval cost on large eval sets
    checkpoint_every: int = 10
    seed: int = 42
    run_root: str = "runs"
    name: str | None = None
    tuned_from: str | None = None

    def run_name(self) -> str:
        if self.name:
            return self.name
        m = self.model
        tag = (
            f"{m.model}{m.n_qubits}q" if m.model != "cnn" else "cnn"
        )
        return f"{tag}-{self.data.dataset}-c{self.data.num_clients}-{self.fed.algorithm}"


def _fields_of(cls) -> set[str]:
    import dataclasses

    return {f.name for f in dataclasses.fields(cls)}


def _known(cls, d: dict) -> dict:
    """``d`` restricted to ``cls``'s fields; unknown keys (a run dir
    written by a newer version) are dropped with a warning."""
    unknown = sorted(set(d) - _fields_of(cls))
    if unknown:
        import warnings

        warnings.warn(
            f"config.json: ignoring unknown {cls.__name__} fields "
            f"{unknown} (written by a newer version?)",
            RuntimeWarning,
            stacklevel=3,
        )
    return {k: v for k, v in d.items() if k in _fields_of(cls)}


def experiment_config_from_dict(d: dict) -> ExperimentConfig:
    """Rebuild an ExperimentConfig from a run dir's ``config.json``
    (written by ``run.metrics.ExperimentRun`` of either package)."""
    d = dict(d)
    data_d = _known(DataConfig, dict(d.pop("data", {})))
    if data_d.get("classes") is not None:
        data_d["classes"] = tuple(int(c) for c in data_d["classes"])
    model_d = _known(ModelConfig, dict(d.pop("model", {})))
    fed_d = _known(FedConfig, dict(d.pop("fed", {})))
    dp_d = fed_d.pop("dp", None)
    dp = DPConfig(**_known(DPConfig, dict(dp_d))) if dp_d else None
    top = _known(ExperimentConfig, d)
    return ExperimentConfig(
        data=DataConfig(**data_d),
        model=ModelConfig(**model_d),
        fed=FedConfig(dp=dp, **fed_d),
        **top,
    )


# [baseline, last_written]: the value of QFEDX_SCAN_LAYERS before an
# explicit ``scan_layers`` override, and the value that override wrote
# (empty = never overridden; baseline None = "was unset"). A later build
# with scan_layers=None gets the operator's pin state back — but only
# while the environment still holds our own write: a value set since by
# someone else is the operator's state and stays.
_SCAN_ENV_SAVED: list = []


def _apply_scan_layers(scan_layers: bool | None) -> None:
    if scan_layers is not None:
        cur = os.environ.get("QFEDX_SCAN_LAYERS")  # qfedx: ignore[QFX002] save/restore ledger — must observe the exact operator state, set or unset
        if not _SCAN_ENV_SAVED or cur != _SCAN_ENV_SAVED[1]:
            _SCAN_ENV_SAVED[:] = [cur, None]
        val = "1" if scan_layers else "0"
        os.environ["QFEDX_SCAN_LAYERS"] = val  # qfedx: ignore[QFX002] save/restore ledger — raw write paired with the raw snapshot above
        _SCAN_ENV_SAVED[1] = val
    elif _SCAN_ENV_SAVED:
        saved, written = _SCAN_ENV_SAVED
        _SCAN_ENV_SAVED.clear()
        if os.environ.get("QFEDX_SCAN_LAYERS") == written:  # qfedx: ignore[QFX002] save/restore ledger — restore only fires while the env still holds our own write
            if saved is None:
                os.environ.pop("QFEDX_SCAN_LAYERS", None)  # qfedx: ignore[QFX002] save/restore ledger — "restore unset" has no pins-helper spelling on purpose
            else:
                os.environ["QFEDX_SCAN_LAYERS"] = saved  # qfedx: ignore[QFX002] save/restore ledger — raw write paired with the raw snapshot above


def build_model(cfg: ExperimentConfig, num_classes: int, device=None):
    """ModelConfig → Model on ``device`` (None = the card)."""
    m = cfg.model
    # The pins are read when the model runs, so the config's explicit
    # route lands in the environment before anything runs it.
    _apply_scan_layers(m.scan_layers)
    noisy = m.depolarizing_p or m.amp_damping_gamma or m.readout_flip \
        or m.shots
    if m.model == "cnn":
        from qfedx_tpu_torch.data.datasets import SPECS
        from qfedx_tpu_torch.models.cnn import make_tiny_cnn

        spec = SPECS[cfg.data.dataset]
        return make_tiny_cnn(num_classes=num_classes, height=spec.height,
                             width=spec.width, in_channels=spec.channels,
                             device=device)
    if m.model == "mps":
        from qfedx_tpu_torch.models.vqc_mps import make_mps_classifier

        if m.encoding != "angle":
            raise ValueError(
                "model='mps' simulates the real-amplitudes circuit family "
                f"(angle/RY encoding only); got encoding={m.encoding!r}"
            )
        if noisy:
            raise ValueError(
                "model='mps' has no noise support; noise channels are a "
                "dense/sv-sharded engine feature"
            )
        if m.sv_size > 1:
            raise ValueError(
                "model='mps' is single-device per sample (O(n·χ²) memory); "
                "sv_size>1 applies to the dense sharded engine"
            )
        return make_mps_classifier(m.n_qubits, n_layers=m.n_layers,
                                   num_classes=num_classes,
                                   bond_dim=m.bond_dim,
                                   init_scale=m.init_scale, device=device)
    if m.model == "qkernel":
        from qfedx_tpu_torch.models.kernel import (
            make_quantum_kernel_classifier,
        )

        if noisy:
            # The kernel head evaluates fidelities in closed form, not a
            # statevector the channels could act on.
            raise ValueError(
                "model='qkernel' has no noise support; noise channels are "
                "a vqc-engine feature (use --model vqc)"
            )
        return make_quantum_kernel_classifier(
            m.n_qubits, n_landmarks=m.n_landmarks, num_classes=num_classes,
            device=device)
    if m.model != "vqc":
        raise ValueError(f"unknown model {m.model!r}")
    noise_model = None
    if noisy:
        from qfedx_tpu_torch.noise.channels import NoiseModel

        noise_model = NoiseModel(
            depolarizing_p=m.depolarizing_p,
            amp_damping_gamma=m.amp_damping_gamma,
            readout_e01=m.readout_flip,
            readout_e10=m.readout_flip,
            shots=m.shots,
            circuit_level=(m.noise_placement == "circuit"),
        )
    if m.sv_size > 1:
        from qfedx_tpu_torch.models.vqc_sharded import (
            make_sharded_vqc_classifier,
        )

        if m.encoding == "reupload":
            raise ValueError(
                "sv_size > 1 supports angle/amplitude encodings "
                "(data reuploading is a dense-engine feature)"
            )
        if m.remat:
            raise ValueError(
                "remat applies to the dense engine; the sv-sharded "
                "path (sv_size > 1) does not support it"
            )
        return make_sharded_vqc_classifier(
            n_qubits=m.n_qubits,
            sv_size=m.sv_size,
            n_layers=m.n_layers,
            num_classes=num_classes,
            encoding=m.encoding,
            init_scale=m.init_scale,
            noise_model=noise_model,
            device=device,
        )
    from qfedx_tpu_torch.models.vqc import make_vqc_classifier

    return make_vqc_classifier(
        n_qubits=m.n_qubits,
        n_layers=m.n_layers,
        num_classes=num_classes,
        encoding=m.encoding,
        init_scale=m.init_scale,
        remat=m.remat,
        device=device,
        noise_model=noise_model,
    )


def build_data(cfg: ExperimentConfig) -> dict[str, Any]:
    """DataConfig → packed client arrays + test set + metadata (numpy)."""
    from qfedx_tpu_torch.data.datasets import load_dataset
    from qfedx_tpu_torch.data.partition import (
        dirichlet_partition,
        iid_partition,
        pack_clients,
        partition_stats,
    )
    from qfedx_tpu_torch import obs
    from qfedx_tpu_torch.data.pipeline import preprocess

    d, m = cfg.data, cfg.model
    is_quantum = m.model in ("vqc", "qkernel", "mps")
    n_features = d.n_features
    features = d.features
    if is_quantum:
        if m.encoding == "amplitude" and m.model == "vqc":
            n_features = n_features or (1 << m.n_qubits)
        else:
            n_features = n_features or m.n_qubits
    else:
        features = "image"

    with obs.span("data.load", dataset=d.dataset):
        spec, train_xy, test_xy = load_dataset(
            d.dataset, d.raw_folder, seed=d.seed,
            synthetic_train=d.synthetic_train,
            synthetic_test=d.synthetic_test,
            synthetic_noise=d.synthetic_noise,
        )
    prep = preprocess(
        train_xy,
        test_xy,
        classes=d.classes,
        val_split=d.val_split,
        features=features,
        n_features=n_features,
        seed=d.seed,
    )
    tr_x, tr_y = prep.train
    if is_quantum and tr_x.shape[-1] != n_features:
        # PCA caps components at the raw feature count silently; a model
        # wider than the features would train dead parameters.
        raise ValueError(
            f"dataset produces {tr_x.shape[-1]} features but the "
            f"{m.n_qubits}-qubit model needs {n_features} "
            f"({m.encoding} encoding); lower --qubits to "
            f"{tr_x.shape[-1]} or pick a wider dataset/feature mode"
        )
    with obs.span("data.partition", scheme=d.partition):
        if d.partition == "dirichlet":
            parts = dirichlet_partition(tr_y, d.num_clients, d.alpha,
                                        seed=d.seed)
        elif d.partition == "iid":
            parts = iid_partition(len(tr_y), d.num_clients, seed=d.seed)
        else:
            raise ValueError(f"unknown partition {d.partition!r}")
        cx, cy, cmask = pack_clients(
            tr_x, tr_y, parts, pad_multiple=cfg.fed.batch_size
        )
    return {
        "cx": cx,
        "cy": cy,
        "cmask": cmask,
        "val": prep.val,
        "test": prep.test,
        "num_classes": prep.num_classes,
        "spec": spec,
        "stats": partition_stats(tr_y, parts, prep.num_classes),
        "parts": parts,
        "train": prep.train,
    }
