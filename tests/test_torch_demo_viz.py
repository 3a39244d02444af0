"""Port vs reference: the encoder demo (run/demo.py) and the data plots
(data/viz.py, ``train --plots``).

- ``run_demo``'s label, ⟨Z⟩ and norm and the amplitude state's
  probabilities are within 1e-6 of the reference's; its PNG is pixel-equal
  to the reference's (``matplotlib.image.imread``).
- ``train --plots`` writes ``client_samples.png`` and
  ``class_distribution.png`` pixel-equal to the reference's plots of the
  same data; the viz functions on the same arrays draw the same pixels.
- Without matplotlib a plotting call raises ``ModuleNotFoundError`` (and
  importing ``data.viz`` or ``run.demo`` loads none).
"""

import functools
import json
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from matplotlib import image as mpimg

from qfedx_tpu.circuits.encoders import amplitude_encode as ramp
from qfedx_tpu.data import viz as rviz
from qfedx_tpu.data.datasets import load_dataset as rload
from qfedx_tpu.data.pipeline import block_downsample as rblock
from qfedx_tpu.data.pipeline import normalize_images as rnorm
from qfedx_tpu.ops.statevector import probabilities as rprobs
from qfedx_tpu.run import cli as rcli
from qfedx_tpu.run import config as rconfig
from qfedx_tpu.run.demo import run_demo as ref_demo
from qfedx_tpu_torch.data import viz as pviz
from qfedx_tpu_torch.run import cli as pcli
from qfedx_tpu_torch.run import config as pconfig
from qfedx_tpu_torch.run import demo as pdemo

DEMO_ATOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the suite runs several workers on one CPU."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _pixels(path):
    return mpimg.imread(str(path))


@pytest.mark.parametrize("dataset", ["mnist", "fashion_mnist"])
def test_demo_matches_reference(tmp_path, capsys, dataset):
    want = ref_demo(out_dir=str(tmp_path / "ref"), dataset=dataset)
    got = pdemo.run_demo(out_dir=str(tmp_path / "port"), dataset=dataset,
                         device="cpu")
    assert got["label"] == want["label"]
    assert abs(got["amp_norm"] - want["amp_norm"]) <= DEMO_ATOL
    np.testing.assert_allclose(got["z"], want["z"], atol=DEMO_ATOL, rtol=0)
    _, (tx, _), _ = rload(dataset)
    small = rblock(rnorm(tx[:1]), 4, 4).reshape(1, 16)
    ref_p = np.asarray(rprobs(ramp(jnp.asarray(small[0]))))
    port_p = pdemo.demo_numbers(dataset, "cpu")["probs"]
    np.testing.assert_allclose(port_p, ref_p, atol=DEMO_ATOL, rtol=0)
    a, b = _pixels(got["png"]), _pixels(want["png"])
    assert a.shape == b.shape and np.array_equal(a, b)
    out = capsys.readouterr().out
    assert "[demo] <Z> per qubit" in out


def test_demo_without_png_needs_no_matplotlib(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    got = pdemo.run_demo(out_dir=str(tmp_path), device="cpu", png=False)
    assert got["png"] is None and len(got["z"]) == 4
    with pytest.raises(ModuleNotFoundError):
        pdemo.run_demo(out_dir=str(tmp_path), device="cpu")


def test_cli_demo(tmp_path):
    got = pcli.main(["demo", "--out", str(tmp_path / "d")], device="cpu")
    assert got["png"] == str(tmp_path / "d" / "encoding_demo.png")


def test_viz_draws_the_reference_pixels(tmp_path):
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (40, 9)).astype(np.float32)
    parts = [np.arange(0, 12), np.arange(12, 15), np.arange(15, 40),
             np.array([], dtype=np.int64)]
    stats = rng.integers(0, 20, (4, 3))
    for mod, tag in ((rviz, "ref"), (pviz, "port")):
        mod.save_client_samples(x, parts, tmp_path / tag / "s.png")
        mod.save_client_samples(x, parts, tmp_path / tag / "s3.png",
                                samples_per_client=3, image_shape=(3, 3))
        mod.save_class_distribution(stats, tmp_path / tag / "c.png",
                                    class_names=["a", "b", "c"])
    for name in ("s.png", "s3.png", "c.png"):
        assert np.array_equal(_pixels(tmp_path / "port" / name),
                              _pixels(tmp_path / "ref" / name)), name


def test_viz_without_matplotlib_raises(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ModuleNotFoundError):
        pviz.save_class_distribution(np.ones((2, 2)), tmp_path / "c.png")
    with pytest.raises(ModuleNotFoundError):
        pviz.save_client_samples(np.ones((2, 4)), [np.arange(2)],
                                 tmp_path / "s.png")


def test_train_plots_match_reference(tmp_path, monkeypatch):
    for cli, cfg in ((pcli, pconfig), (rcli, rconfig)):
        monkeypatch.setattr(cli, "DataConfig", functools.partial(
            cfg.DataConfig, synthetic_train=192, synthetic_test=96))
    argv = ["train", "--model", "vqc", "--qubits", "4", "--layers", "1",
            "--classes", "0,1,2", "--clients", "3", "--rounds", "1",
            "--local-epochs", "1", "--rounds-per-call", "1",
            "--partition", "dirichlet", "--alpha", "0.3", "--plots",
            "--run-root", str(tmp_path), "--name", "plots"]
    pcli.main(argv, device="cpu")
    run = tmp_path / "plots"
    data = rconfig.build_data(rcli.config_from_args(
        rcli.build_parser().parse_args(argv)))
    rviz.save_client_samples(data["train"][0], data["parts"],
                             tmp_path / "ref_samples.png")
    rviz.save_class_distribution(data["stats"], tmp_path / "ref_dist.png")
    for got, want in (("client_samples.png", "ref_samples.png"),
                      ("class_distribution.png", "ref_dist.png")):
        assert np.array_equal(_pixels(run / got), _pixels(tmp_path / want))
    summary = json.loads((run / "summary.json").read_text())
    assert summary["rounds"] == 1
