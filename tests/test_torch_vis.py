"""Attention visualisation (vis/, cli/vis.py) against the JAX package.

On the JAX tests/test_vis.py graph (60 nodes, heads [2, 1]) with the JAX
weights carried over: the port's alpha within 1e-5 of the JAX
extract_attention's; each statistic, and the histogram bar heights of
the three figures, equal to the JAX package's when both are given the
same JAX alpha. Then the port's CLI end to end on the CPU, each of its
three routes: synthetic Cora and PATTERN from seed-0 weights, Cora from a
port `epoch-1` checkpoint, and the PPI `{epoch}` sweep over
Trainer.save_checkpoint files.
"""

import os

import jax
import matplotlib
import numpy as np
import pytest
import torch

from gat_pytorch_tpu.graph import transforms as jT
from gat_pytorch_tpu.models import gat as jgat
from gat_pytorch_tpu.vis import attention as jA
from gat_pytorch_tpu.vis import plots as jP
from gat_pytorch_tpu_torch.graph import transforms as tT
from gat_pytorch_tpu_torch.models import gat as tgat
from gat_pytorch_tpu_torch.utils.convert import params_from_jax
from gat_pytorch_tpu_torch.vis import attention as tA
from gat_pytorch_tpu_torch.vis import plots as tP

from .test_checkpoint_parity import CKPT_DIR
from .test_torch_knobs import default_knobs  # noqa: F401

matplotlib.use("Agg")

CFG = dict(num_input_node_features=10, num_layers=2,
           num_heads_per_layer=[2, 1], heads_concat_per_layer=[True, False],
           head_output_features_per_layer=[10, 8, 3], num_classes=3,
           add_skip_connection=[False, False], dropout=0.0)


@pytest.fixture(scope="module")
def setup():
    """(JAX graph, port graph, JAX params, JAX (logits, alpha)) on the
    JAX test's graph."""
    rng = np.random.default_rng(0)
    n = 60
    senders = np.repeat(np.arange(n), 4)
    receivers = rng.integers(0, n, n * 4)
    x = rng.normal(size=(n, 10)).astype(np.float32)
    y = rng.integers(0, 3, n).astype(np.int32)
    jgraph = jT.canonicalize(x, senders, receivers, y=y)
    tgraph = tT.canonicalize(x, senders, receivers, y=y)
    jparams = jgat.init_gat_model(jax.random.key(0), jgat.GATConfig(**CFG))
    jout = jA.extract_attention(jparams, jgat.GATConfig(**CFG), jgraph)
    return jgraph, tgraph, jparams, jout


def _port_params(jparams):
    return params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                           device="cpu")


def test_alpha_matches_the_jax_extraction(setup):
    jgraph, tgraph, jparams, (jlogits, jatt) = setup
    logits, att = tA.extract_attention(_port_params(jparams),
                                       tgat.GATConfig(**CFG), tgraph)
    assert isinstance(logits, np.ndarray) and len(att) == len(jatt) == 2
    np.testing.assert_allclose(logits, np.asarray(jlogits), atol=1e-5)
    for got, want in zip(att, jatt):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    # each real node's alphas sum to 1 (the JAX test's check)
    for alpha in att:
        for idx in tA.neighbourhood_slices(tgraph).values():
            np.testing.assert_allclose(alpha[idx].sum(axis=0), 1.0,
                                       rtol=1e-4)


def test_statistics_equal_the_jax_ones_on_the_same_alpha(setup):
    jgraph, tgraph, _, (_, jatt) = setup
    jn, tn = jA.neighbourhood_slices(jgraph), tA.neighbourhood_slices(tgraph)
    assert list(tn) == list(jn)
    for k in jn:
        np.testing.assert_array_equal(tn[k], jn[k])
    for alpha in jatt:
        for head in [None] + list(range(alpha.shape[1])):
            for got, want in zip(tA.attention_entropies(alpha, tgraph, head),
                                 jA.attention_entropies(alpha, jgraph, head)):
                np.testing.assert_array_equal(got, want)
        for head in range(alpha.shape[1]):
            for clip in (5.0, 1.5):
                for got, want in zip(
                        tA.degree_scaled_weights(alpha, tgraph, head, clip),
                        jA.degree_scaled_weights(alpha, jgraph, head, clip)):
                    np.testing.assert_array_equal(got, want)
            for node in list(jn)[:6]:
                got = tA.node_neighbourhood(alpha, tgraph, node, head)
                want = jA.node_neighbourhood(alpha, jgraph, node, head)
                assert got.keys() == want.keys()
                for k in want:
                    np.testing.assert_array_equal(got[k], want[k])
    for degree in range(1, 9):
        np.testing.assert_array_equal(tA.nodes_of_degree(tgraph, degree),
                                      jA.nodes_of_degree(jgraph, degree))
    ents, unis = tA.attention_entropies(jatt[0], tgraph)
    assert ents.shape == unis.shape
    assert (ents <= unis + 1e-5).all() and (ents >= -1e-7).all()
    # the sink node: padding edges only
    with pytest.raises(ValueError, match="no in-edges"):
        tA.node_neighbourhood(jatt[0], tgraph, tgraph.num_nodes - 1)


def test_degree_scaled_weights_are_one_under_const_attention(setup):
    """ConstGAT (uniform attention): alpha * deg == 1."""
    _, tgraph, _, _ = setup
    cfg = tgat.GATConfig(**{**CFG, "const_attention": True})
    params = tgat.init_gat_model(cfg, seed=1, device="cpu")
    _, att = tA.extract_attention(params, cfg, tgraph)
    for alpha in att:
        w, uni = tA.degree_scaled_weights(alpha, tgraph)
        assert w.size == int(tgraph.edge_mask.sum())
        np.testing.assert_allclose(w, 1.0, rtol=1e-4)
        np.testing.assert_array_equal(uni, np.ones_like(w))


def _bars(fig):
    return [[(p.get_x(), p.get_width(), p.get_height()) for p in ax.patches]
            for ax in fig.axes]


def test_figures_render_with_the_jax_figures_bars(tmp_path, setup):
    """The three figures as PNGs over 1000 bytes; from the same alpha the
    histograms' bars (and the star plot's spokes) are the JAX figures'."""
    import matplotlib.pyplot as plt
    jgraph, tgraph, _, (_, jatt) = setup
    node = int(np.asarray(jgraph.receivers)[0])
    draws = [
        ("e", lambda P, g, out, **kw: P.draw_entropy_histogram(
            jatt, g, "Test", out=out, **kw), {}),
        ("e_all", lambda P, g, out, **kw: P.draw_entropy_histogram(
            jatt, g, "Test", out=out, **kw), {"skip_last_layer": False}),
        ("w", lambda P, g, out, **kw: P.draw_weights_histogram(
            jatt, g, "PPI", out=out, **kw), {}),
        ("w_lin", lambda P, g, out, **kw: P.draw_weights_histogram(
            jatt, g, "Test", out=out, **kw), {"epoch_label": "5epochs"}),
        ("n", lambda P, g, out, **kw: P.draw_neighbour_attention_distribution(
            jatt, g, node, out=out, **kw), {}),
    ]
    for name, draw, kw in draws:
        tfig = draw(tP, tgraph, str(tmp_path / f"{name}.png"), **kw)
        jfig = draw(jP, jgraph, None, **kw)
        assert os.path.getsize(tmp_path / f"{name}.png") > 1000, name
        assert _bars(tfig) == _bars(jfig), name
        assert [ax.get_yscale() for ax in tfig.axes] == \
            [ax.get_yscale() for ax in jfig.axes], name
        assert tfig._suptitle is None or \
            tfig._suptitle.get_text() == jfig._suptitle.get_text()
        if name == "w":     # log-y by default for PPI and PATTERN
            assert {ax.get_yscale() for ax in tfig.axes[:2]} == {"log"}
        if name == "n":
            for ta, ja in zip(tfig.axes, jfig.axes):
                assert [ln.get_linewidth() for ln in ta.lines] == \
                    [ln.get_linewidth() for ln in ja.lines]
        plt.close("all")
    # skip_last_layer keeps the reference's off-by-one: one layer drawn
    tfig = tP.draw_entropy_histogram(jatt, tgraph)
    assert len(tfig.axes) == jatt[0].shape[1]
    assert len(_bars(tfig)[0]) == 2 * 29
    plt.close("all")


def test_vis_cli_refuses_the_cpu_unless_asked(monkeypatch, tmp_path):
    from gat_pytorch_tpu_torch.cli.vis import main
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--dataset", "Cora", "--out_dir", str(tmp_path),
              "--synthetic"])
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("dataset,vis_type", [("Cora", "Neighbourhood"),
                                              ("PATTERN", "Entropy")])
def test_vis_cli_end_to_end(tmp_path, capsys, dataset, vis_type):
    """The Neighbourhood route (its default centre: the first degree-10
    node) on synthetic Cora, the Entropy route on PATTERN's first test
    graph (the Weight route: the two tests below)."""
    from gat_pytorch_tpu_torch.cli.vis import main
    rc = main(["--dataset", dataset, "--vis_type", vis_type, "--device",
               "cpu", "--out_dir", str(tmp_path), "--synthetic"])
    assert rc == 0
    out = tmp_path / f"{dataset}-{vis_type}.png"
    assert os.path.getsize(out) > 1000
    assert f"wrote {out}" in capsys.readouterr().out


def test_vis_cli_epoch_snapshot(tmp_path, monkeypatch):
    """The CLI draws from the port's own epoch-1 snapshot (cli.train with
    checkpoint_every_n_epochs), and the parameters it loads are the
    snapshot's."""
    from gat_pytorch_tpu_torch.cli import train as cli_train
    from gat_pytorch_tpu_torch.cli import vis
    from gat_pytorch_tpu_torch.utils.config import get_config
    monkeypatch.chdir(tmp_path)
    cfg = get_config("Cora", synthetic=True, num_epochs=1, device="cpu",
                     checkpoint_dir=str(tmp_path / "ck"),
                     checkpoint_every_n_epochs=1)
    cfg.log_every = 0
    cli_train.run(cfg)
    snap = str(tmp_path / "ck" / "epoch-1")
    assert os.path.isfile(snap)
    rc = vis.main(["--dataset", "Cora", "--vis_type", "Weight",
                   "--checkpoint_path", snap, "--out_dir", str(tmp_path),
                   "--synthetic", "--device", "cpu"])
    assert rc == 0
    assert os.path.getsize(tmp_path / "Cora-Weight.png") > 1000
    run_cfg = get_config("Cora")
    loaded = vis._load_params(snap, run_cfg.gat_config(), run_cfg, "cpu")
    saved = torch.load(snap, weights_only=True)["params"]
    for got, want in zip(tgat.parameters(loaded), tgat.parameters(saved)):
        assert torch.equal(got, want)
    # a checkpoint_dir holding best loads its best
    best = vis._load_params(str(tmp_path / "ck"), run_cfg.gat_config(),
                            run_cfg, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(
        tgat.parameters(best), tgat.parameters(torch.load(
            tmp_path / "ck" / "best", weights_only=True)["params"])))


def test_vis_cli_ppi_epoch_sweep(tmp_path, capsys):
    """The reference's PPI Weight sweep: `{epoch}` over 1, 5, 20, 50, 100;
    two checkpoints written by Trainer.save_checkpoint (seed 0's and seed
    1's weights), the missing epochs skipped with a message."""
    from gat_pytorch_tpu_torch.cli.vis import main
    from gat_pytorch_tpu_torch.train import optim as O
    from gat_pytorch_tpu_torch.train.tasks import make_task
    from gat_pytorch_tpu_torch.train.trainer import Trainer, TrainState
    from gat_pytorch_tpu_torch.utils.config import get_config
    cfg = get_config("PPI").gat_config()
    trainer = Trainer(cfg=cfg, task=make_task("PPI"), learning_rate=5e-3,
                      device="cpu", checkpoint_dir=str(tmp_path / "ck"))
    for epoch, seed in ((1, 0), (20, 1)):
        params = tgat.init_gat_model(cfg, seed=seed, device="cpu")
        state = TrainState(params, O.adam_l2(tgat.parameters(params), 5e-3,
                                             0.0), torch.Generator())
        trainer.save_checkpoint(state, epoch, 1.0, name=f"epoch-{epoch}")
    pattern = str(tmp_path / "ck" / "epoch-{epoch}")
    rc = main(["--dataset", "PPI", "--vis_type", "Weight",
               "--checkpoint_path", pattern, "--out_dir",
               str(tmp_path / "figs"), "--synthetic", "--device", "cpu"])
    assert rc == 0
    figs = sorted(os.listdir(tmp_path / "figs"))
    assert figs == ["PPI-Weight-1epochs.png", "PPI-Weight-20epochs.png"]
    pngs = [(tmp_path / "figs" / f).read_bytes() for f in figs]
    assert all(len(p) > 1000 for p in pngs) and pngs[0] != pngs[1]
    err = capsys.readouterr().err
    for epoch in (5, 50, 100):
        assert f"missing {pattern.format(epoch=epoch)}, skipping" in err
    assert "epoch-1," not in err and "epoch-20," not in err


def test_vis_cli_reference_checkpoint(tmp_path):
    ckpt = os.path.join(CKPT_DIR, "Cora-100epochs.ckpt")
    if not os.path.exists(ckpt):
        pytest.skip("reference checkpoints not mounted")
    from gat_pytorch_tpu_torch.cli.vis import main
    rc = main(["--dataset", "Cora", "--vis_type", "Weight",
               "--checkpoint_path", ckpt, "--out_dir", str(tmp_path),
               "--synthetic", "--device", "cpu"])
    assert rc == 0
    assert os.path.exists(tmp_path / "Cora-Weight.png")
