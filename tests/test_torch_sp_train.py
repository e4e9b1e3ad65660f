"""The port's TinyPoint trainer (``ops/sp_train.py``) against the JAX
package's, on the CPU.

The data generator must give the JAX module's arrays byte for byte from one
seed; the losses, the gradients and Adam's steps are held to the JAX
trainer (flax and optax on the CPU; the trainer reaches no Pallas kernel)
from carried weights: JAX's initialisation at ``jax.random.key(0)`` through
``interop.superpoint_params_from_flax``, and the port's gradients back to
flax layout through ``superpoint.flax_params_from_state_dict``. Sizes are
TinyPoint at B=2, 48x64 (48 cells) and the full-width net at B=1, 48x64.
Each tolerance is stated where it is used.
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from sfmfromscratch_tpu.ops import sp_train as jst
from sfmfromscratch_tpu.ops import superpoint as jsp

from sfmfromscratch_tpu_torch import interop
from sfmfromscratch_tpu_torch.ops import sp_train as tst
from sfmfromscratch_tpu_torch.ops import superpoint as tsp

torch.set_num_threads(1)   # tier-1 runs several pytest workers at once

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HW = (48, 64)


def _np(x):
    return np.asarray(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x)


def _same_bytes(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.dtype == ref.dtype and got.shape == ref.shape, (got.dtype, ref.dtype, got.shape)
    assert got.tobytes() == ref.tobytes()


def _flax_init(width, seed=0):
    """A JAX ``SuperPointNet`` (``tiny()`` or full width) and its variables
    at ``jax.random.key(seed)``, as ``sp_train.train`` draws them."""
    net = jsp.SuperPointNet.tiny() if width == "tiny" else jsp.SuperPointNet()
    return net, net.init(jax.random.key(seed), jnp.zeros((1,) + HW + (1,)))


def _carried(width, variables):
    """The port's net at the same width with the JAX weights."""
    net = tsp.SuperPointNet.tiny() if width == "tiny" else tsp.SuperPointNet()
    net.load_state_dict(interop.superpoint_params_from_flax(variables))
    return net


def _jax_value_and_grad(net, params, batch, lambda_desc=1.0):
    """``sp_train.py:259-265``'s loss with its gradient."""
    def loss_fn(p):
        imgs, labs, imgs_w, labs_w, Hs = batch
        semi_a, desc_a = net.apply({"params": p}, imgs[..., None])
        semi_b, desc_b = net.apply({"params": p}, imgs_w[..., None])
        ld = jst._detector_ce(semi_a, labs) + jst._detector_ce(semi_b, labs_w)
        ldesc = jnp.mean(jax.vmap(jst._descriptor_hinge)(desc_a, desc_b, Hs))
        return ld + lambda_desc * ldesc, (ld, ldesc)

    return jax.value_and_grad(loss_fn, has_aux=True)(params)


# --- the data generator: byte for byte ----------------------------------------

@pytest.mark.parametrize("seed, hw", [(0, HW), (1, HW), (5, (120, 160)), (129, (16, 16))])
def test_draw_shapes_matches_jax(seed, hw):
    """Image and corners byte-equal; shapes seed 129 at 16x16 keeps no
    corner inside the border."""
    got = tst._draw_shapes(np.random.default_rng(seed), *hw)
    ref = jst._draw_shapes(np.random.default_rng(seed), *hw)
    for g, r in zip(got, ref, strict=True):
        _same_bytes(g, r)
    if seed == 129:
        assert got[1].shape == (0, 2)


@pytest.mark.parametrize("seed, hw", [(1, (16, 16)), (2, HW), (3, (120, 160))])
def test_draw_texture_matches_jax(seed, hw):
    """Image and Shi-Tomasi corners byte-equal; seed 1 at 16x16 finds none."""
    got = tst._draw_texture(np.random.default_rng(seed), *hw)
    ref = jst._draw_texture(np.random.default_rng(seed), *hw)
    for g, r in zip(got, ref, strict=True):
        _same_bytes(g, r)
    if seed == 1:
        assert got[1].shape == (0, 2)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_homography_jitter_and_warp_match_jax(seed):
    """``_random_homography``, ``_photometric_jitter`` and ``_warp_points``
    byte-equal, the generator left in the same state; a homography whose w
    changes sign over the points keeps w's sign in both."""
    rg, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    _same_bytes(tst._random_homography(rg, *HW), jst._random_homography(rj, *HW))
    img = np.random.default_rng(seed + 10).uniform(-0.1, 1.1, HW).astype(np.float32)
    _same_bytes(tst._photometric_jitter(rg, img), jst._photometric_jitter(rj, img))
    assert rg.uniform() == rj.uniform()
    pts = np.random.default_rng(seed).uniform(0, 64, (40, 2)).astype(np.float32)
    for Hm in (tst._random_homography(np.random.default_rng(seed), *HW),
               np.array([[1, 0, 0], [0, 1, 0], [0.02, 0, -0.5]], np.float32)):
        _same_bytes(tst._warp_points(Hm, pts), jst._warp_points(Hm, pts))
    flip = np.array([[1, 0, 0], [0, 1, 0], [0.02, 0, -0.5]], np.float32)
    w = pts[:, 0] * 0.02 - 0.5
    assert (w < 0).any() and (w > 0).any()
    np.testing.assert_allclose(tst._warp_points(flip, pts)[:, 0] * np.abs(w),
                               pts[:, 0] * np.sign(w), rtol=1e-5)
    empty = np.zeros((0, 2), np.float32)
    _same_bytes(tst._warp_points(flip, empty), jst._warp_points(flip, empty))


def test_cell_labels_match_jax():
    """Labels byte-equal, with corners off the image, on its edges and
    several in one cell (the last one wins), and with no corner."""
    r = np.random.default_rng(3)
    corners = np.concatenate([r.uniform(-8, 72, (60, 2)),
                              [[9.0, 9.0], [14.4, 10.6], [63.6, 47.4], [0.0, 0.0]]])
    corners = corners.astype(np.float32)
    got = tst._cell_labels(corners, *HW)
    _same_bytes(got, jst._cell_labels(corners, *HW))
    assert got[1, 1] == 8 * 3 + 6     # (14.4, 10.6) after (9, 9) in cell (1, 1)
    empty = np.zeros((0, 2), np.float32)
    _same_bytes(tst._cell_labels(empty, *HW), jst._cell_labels(empty, *HW))


@pytest.mark.parametrize("seed, B, hw", [(0, 2, HW), (1, 3, HW), (3, 2, (16, 24)),
                                         (0, 2, (16, 16))])
def test_make_batch_matches_jax_bytes(seed, B, hw):
    """The five arrays of ``make_batch`` byte-equal from one seed, and the
    generator in the same state after it. Seed 3 at 16x24 has a sample with
    no corner; seed 0 at 16x16 a batch with none."""
    rg, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got, ref = tst.make_batch(rg, B, *hw), jst.make_batch(rj, B, *hw)
    for g, r in zip(got, ref, strict=True):
        _same_bytes(g, r)
    assert rg.uniform() == rj.uniform()
    no_corner = (got[1] == 64).all(axis=(1, 2))
    if (seed, hw) == (3, (16, 24)):
        assert no_corner.tolist() == [False, True]
    if hw == (16, 16):
        assert no_corner.all()


# --- the losses ---------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "no_corner"])
def test_detector_ce_matches_jax(case):
    """The weighted cross-entropy of (B, 65, Hc, Wc) logits equals JAX's on
    the NHWC logits within 1e-5 relative; the weights count corner and
    dustbin cells over the whole batch (also with no corner cell)."""
    r = np.random.default_rng(4)
    semi = (r.standard_normal((2, 6, 8, 65)) * 3).astype(np.float32)
    labs = np.where(r.uniform(size=(2, 6, 8)) < 0.3, r.integers(0, 64, (2, 6, 8)), 64)
    labs[1] = 64                          # one image has no corner cell
    if case == "no_corner":
        labs[:] = 64
    labs = labs.astype(np.int32)
    ref = float(jst._detector_ce(jnp.asarray(semi), jnp.asarray(labs)))
    got = tst._detector_ce(torch.as_tensor(semi).permute(0, 3, 1, 2),
                           torch.as_tensor(labs).long())
    assert float(got) == pytest.approx(ref, rel=1e-5)
    # Batch-wide weights: not the mean of per-image losses.
    per_image = [float(tst._detector_ce(torch.as_tensor(semi[b:b + 1]).permute(0, 3, 1, 2),
                                        torch.as_tensor(labs[b:b + 1]).long())) for b in range(2)]
    if case == "random":
        assert abs(float(got) - np.mean(per_image)) > 1e-3


@pytest.mark.parametrize("case", ["random", "w_crosses_zero"])
def test_descriptor_hinge_matches_jax(case):
    """The per-sample hinge equals JAX's vmapped one within 1e-5 relative,
    the cells in JAX's order; the second case's homography sends w through
    zero at cell centre x = 20 (|w| < 1e-8 becomes +1e-8)."""
    r = np.random.default_rng(6)
    B, Hc, Wc, D = 2, 6, 8, 32
    da = r.standard_normal((B, Hc, Wc, D)).astype(np.float32)
    db = r.standard_normal((B, Hc, Wc, D)).astype(np.float32)
    da /= np.linalg.norm(da, axis=-1, keepdims=True)
    db /= np.linalg.norm(db, axis=-1, keepdims=True)
    Hs = np.stack([tst._random_homography(np.random.default_rng(s), *HW)
                   for s in range(B)]).astype(np.float32)
    if case == "w_crosses_zero":
        Hs[1] = np.array([[1, 0, 0], [0, 1, 0], [0.01, 0, -0.2]], np.float32)
    # Half the cells of view B copy their warped partner's descriptor in
    # view A, so the positives are informative.
    db[0, :3] = da[0, :3]
    ref = np.asarray(jax.vmap(jst._descriptor_hinge)(jnp.asarray(da), jnp.asarray(db),
                                                      jnp.asarray(Hs)))
    got = tst._descriptor_hinge(torch.as_tensor(da).permute(0, 3, 1, 2),
                                torch.as_tensor(db).permute(0, 3, 1, 2), torch.as_tensor(Hs))
    assert got.shape == (B,)
    np.testing.assert_allclose(_np(got), ref, rtol=1e-5)


# --- the train step -----------------------------------------------------------

def _batch(seed, B, dither=True):
    """``make_batch`` at 48x64; with ``dither``, both views plus uniform
    noise of at most 1e-3 (drawn from ``seed``). The generator clips 2-3% of
    the pixels to exactly 0 or 1, and flat patches tie in the net's 2x2 max
    pools; a tie's gradient goes to whichever element each package's
    rounding makes the larger, which moves early-layer gradient elements
    well past 1e-4 of the tensor's largest
    (test_raw_batch_gradient_matches_float64). Dithered, every max is unique
    and the gradient is one function."""
    b = tst.make_batch(np.random.default_rng(seed), B, *HW)
    if not dither:
        return b
    r = np.random.default_rng(seed + 1000)
    imgs, labs, imgs_w, labs_w, Hs = b
    return ((imgs + r.uniform(0, 1e-3, imgs.shape)).astype(np.float32), labs,
            (imgs_w + r.uniform(0, 1e-3, imgs_w.shape)).astype(np.float32), labs_w, Hs)


@pytest.mark.parametrize("width, B", [("tiny", 2), ("full", 1)])
def test_one_step_loss_and_gradients_match_jax(width, B):
    """One step from carried JAX weights on one batch: loss, ``ld`` and
    ``ldesc`` within 1e-5 relative, and each gradient, back in flax layout,
    within 1e-4 of that tensor's largest |g|. The port's gradients are the
    ones its Adam step used (left in ``.grad``)."""
    jnet, variables = _flax_init(width)
    net = _carried(width, variables)
    batch = _batch(1, B)
    (loss, (ld, ldesc)), grads = _jax_value_and_grad(
        jnet, variables["params"], tuple(jnp.asarray(a) for a in batch))
    _, step = tst.make_train_step(net)
    got = step(batch)
    for g, r in zip(got, (loss, ld, ldesc), strict=True):
        assert g.dtype == torch.float32 and g.ndim == 0
        assert float(g) == pytest.approx(float(r), rel=1e-5)
    tg = tsp.flax_params_from_state_dict({n: p.grad for n, p in net.named_parameters()})
    assert set(tg) == set(grads)
    for layer, leaves in grads.items():
        for leaf, ref in leaves.items():
            ref = np.asarray(ref)
            assert tg[layer][leaf].shape == ref.shape
            np.testing.assert_allclose(tg[layer][leaf], ref, rtol=0,
                                       atol=1e-4 * np.abs(ref).max(), err_msg=f"{layer}.{leaf}")


def _port_grads(net, batch, dtype):
    """The port's loss and flax-layout gradients on ``batch`` with ``net``
    and the batch in ``dtype``, in the train step's scope."""
    imgs, labs, imgs_w, labs_w, Hs = (torch.as_tensor(a) for a in batch)
    net = net.to(dtype)
    with tst.train_scope():
        semi_a, desc_a = net(imgs[:, None].to(dtype))
        semi_b, desc_b = net(imgs_w[:, None].to(dtype))
        ld = tst._detector_ce(semi_a, labs.long()) + tst._detector_ce(semi_b, labs_w.long())
        loss = ld + torch.mean(tst._descriptor_hinge(desc_a, desc_b, Hs))
        loss.backward()
    return tsp.flax_params_from_state_dict({n: p.grad for n, p in net.named_parameters()})


@pytest.mark.parametrize("width, B", [("tiny", 2), ("full", 1)])
def test_raw_batch_gradient_matches_float64(width, B):
    """On an undithered batch (seed 10: 2% of a view's pixels clipped to 0
    or 1), the port's float32 gradient is within 1e-5 of each tensor's
    largest |g| of the same net in float64: its max pools route the ties as
    its float64 run does. JAX's float32 gradient on such a batch parts from
    the float64 one in the early layers, where XLA's rounding routes the
    ties, so the comparisons with JAX above dither."""
    _, variables = _flax_init(width)
    batch = _batch(10, B, dither=False)
    assert any(((v == 0) | (v == 1)).mean() > 0.01 for v in (batch[0], batch[2]))
    g32 = _port_grads(_carried(width, variables), batch, torch.float32)
    g64 = _port_grads(_carried(width, variables), batch, torch.float64)
    for layer, leaves in g64.items():
        for leaf, ref in leaves.items():
            np.testing.assert_allclose(g32[layer][leaf], ref, rtol=0,
                                       atol=1e-5 * np.abs(ref).max(), err_msg=f"{layer}.{leaf}")


def test_five_adam_steps_match_optax():
    """Five TinyPoint steps from carried weights and optax's fresh state on
    five batches (B=2): each step's losses within 1e-4 relative, and every
    weight within 2.5e-4 of JAX's (5% of lr x steps: Adam's first steps move
    a weight by about lr, whatever the gradient's size, so the gradients are
    compared tightly above)."""
    width, B = "tiny", 2
    jnet, variables = _flax_init(width)
    net = _carried(width, variables)
    tx, jstep = jst.make_train_step(jnet)
    params, opt_state = variables["params"], tx.init(variables["params"])
    optimizer, step = tst.make_train_step(net)
    assert isinstance(optimizer, torch.optim.Adam)
    assert optimizer.defaults["lr"] == 1e-3 and optimizer.defaults["betas"] == (0.9, 0.999)
    assert optimizer.defaults["eps"] == 1e-8
    for i in range(5):
        batch = _batch(10 + i, B)
        params, opt_state, *ref = jstep(params, opt_state, tuple(jnp.asarray(a) for a in batch))
        got = step(batch)
        for g, r in zip(got, ref, strict=True):
            assert float(g) == pytest.approx(float(r), rel=1e-4), i
    tp = tsp.flax_params_from_state_dict(net.state_dict())
    for layer, leaves in params.items():
        for leaf, ref in leaves.items():
            np.testing.assert_allclose(tp[layer][leaf], np.asarray(ref), rtol=0, atol=2.5e-4,
                                       err_msg=f"{layer}.{leaf}")


def _flags():
    return (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
            torch.backends.mkldnn.enabled)


def test_step_runs_backward_in_the_train_scope():
    """The backward runs inside the step's scope (TF32 off, cuDNN
    deterministic, no autotuning, no oneDNN), and the flags are restored
    after it."""
    net = tsp.SuperPointNet.tiny()
    net.reset_parameters_flax(torch.Generator().manual_seed(0))
    seen = []
    net.conv1a.weight.register_hook(lambda g: seen.append(_flags()))
    net.convDb.weight.register_hook(lambda g: seen.append(_flags()))
    old = _flags()
    try:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.mkldnn.enabled) = (True, True, False, True, True)
        _, step = tst.make_train_step(net)
        step(_batch(0, 2))
        assert len(seen) >= 2 and set(seen) == {(False, False, True, False, False)}
        assert _flags() == (True, True, False, True, True)
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.mkldnn.enabled) = old


# --- train() ---------------------------------------------------------------------

def _recorder(fn, out):
    def wrapped(*a, **k):
        r = fn(*a, **k)
        out.append(r)
        return r
    return wrapped


def _step_recorder(make, out):
    """``make_train_step`` whose step keeps each (loss, ld, ldesc) as floats."""
    def make_recording(net, *a, **k):
        tx, step = make(net, *a, **k)

        def recording(*sa):
            r = step(*sa)
            out.append([float(v) for v in r[-3:]])
            return r
        return tx, recording
    return make_recording


def _printed(text):
    """[(step, loss, det, desc)] from the trainers' lines."""
    rows = []
    for line in text.splitlines():
        if line.startswith("step "):
            head, rest = line.split(":", 1)
            nums = rest.replace("(", " ").replace(")", " ").replace(",", " ").split()
            rows.append((int(head.split()[1]), float(nums[1]), float(nums[3]), float(nums[5])))
    return rows


def test_train_matches_jax(monkeypatch, capsys):
    """``train(steps=3, batch=2, hw=(48, 64), seed=0, log_every=1)`` on the
    CPU against JAX's ``train`` with the same arguments, the port started
    from JAX's ``key(0)`` weights: the same batches byte for byte, every
    step's losses within 1e-4 relative, the same printed lines within 1e-4
    relative or one unit of the last printed digit, and the trained
    weights within 2.5e-4 (5% of lr x steps at 5 steps)."""
    _, variables = _flax_init("tiny")
    carried = interop.superpoint_params_from_flax(variables)
    monkeypatch.setattr(tsp.SuperPointNet, "reset_parameters_flax",
                        lambda self, generator: self.load_state_dict(carried))
    batches, losses = {"jax": [], "port": []}, {"jax": [], "port": []}
    for mod, key in ((jst, "jax"), (tst, "port")):
        monkeypatch.setattr(mod, "make_batch", _recorder(mod.make_batch, batches[key]))
        monkeypatch.setattr(mod, "make_train_step",
                            _step_recorder(mod.make_train_step, losses[key]))
    kw = dict(steps=3, batch=2, hw=HW, seed=0, log_every=1)
    jvars, _ = jst.train(**kw)
    jout = capsys.readouterr().out
    net = tst.train(device="cpu", **kw)
    tout = capsys.readouterr().out
    assert isinstance(net, tsp.SuperPointNet) and net.desc_dim == 128
    assert len(batches["port"]) == len(batches["jax"]) == 3
    for got, ref in zip(batches["port"], batches["jax"], strict=True):
        for g, r in zip(got, ref, strict=True):
            _same_bytes(g, r)
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)
    pj, pt = _printed(jout), _printed(tout)
    assert [r[0] for r in pt] == [r[0] for r in pj] == [0, 1, 2]
    for a, b in zip(pt, pj, strict=True):
        for x, y in zip(a[1:], b[1:]):
            assert abs(x - y) <= max(1e-4 * abs(y), 1e-4 + 1e-9), (a, b)
    tp = tsp.flax_params_from_state_dict(net.state_dict())
    for layer, leaves in jvars["params"].items():
        for leaf, ref in leaves.items():
            np.testing.assert_allclose(tp[layer][leaf], np.asarray(ref), rtol=0, atol=2.5e-4)


def test_train_draws_its_initialisation_from_seed():
    """A given net is architecture only: ``train`` redraws its weights with
    flax's initialisation from ``torch.Generator().manual_seed(seed)``,
    without touching the batch stream (0 steps leave them as drawn)."""
    net = tsp.SuperPointNet.tiny()
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(0.5)
    out = tst.train(steps=0, seed=3, net=net, device="cpu")
    assert out is net
    ref = tsp.SuperPointNet.tiny()
    ref.reset_parameters_flax(torch.Generator().manual_seed(3))
    for a, b in zip(out.state_dict().values(), ref.state_dict().values(), strict=True):
        assert torch.equal(a, b)


def test_train_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.train(steps=1, batch=1, hw=(16, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        tst.train(steps=1, batch=1, hw=(16, 16), device="cuda")


# --- checkpoints ------------------------------------------------------------------

def test_checkpoint_loads_in_both_packages(tmp_path):
    """A net the port trained, saved with ``save_flax_weights``, loads in
    both packages' ``load_flax_weights`` to the same weights and widths."""
    net = tst.train(steps=1, batch=1, hw=(16, 16), seed=2, log_every=0, device="cpu")
    path = str(tmp_path / "tinypoint.npz")
    tsp.save_flax_weights(path, net)
    back = tsp.load_flax_weights(path)
    assert (back.channels, back.desc_dim) == (net.channels, net.desc_dim)
    for a, b in zip(back.state_dict().values(), net.state_dict().values(), strict=True):
        assert torch.equal(a, b)
    jvars, jnet = jsp.load_flax_weights(path)
    assert (tuple(jnet.channels), jnet.desc_dim) == (net.channels, net.desc_dim)
    mine = tsp.flax_params_from_state_dict(net.state_dict())
    for layer, leaves in jvars["params"].items():
        for leaf, v in leaves.items():
            _same_bytes(np.asarray(v), mine[layer][leaf])


def test_committed_initial_weights_are_jax_key0():
    """``tests/data/tinypoint_init_key0.npz`` (the train phase's carried
    initial weights) is JAX's ``SuperPointNet.tiny()`` at ``key(0)``."""
    _, variables = _flax_init("tiny")
    net = tsp.load_flax_weights(os.path.join(ROOT, "tests", "data", "tinypoint_init_key0.npz"))
    assert (net.channels, net.desc_dim) == ((32, 32, 64, 64, 128), 128)
    ref = interop.superpoint_params_from_flax(variables)
    for name, v in net.state_dict().items():
        assert torch.equal(v, ref[name]), name
