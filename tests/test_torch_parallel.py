"""The port's meshes (``lstm_unet_tpu_torch/parallel``) on the CPU: runs of 2
and 2 x 2 processes over gloo, with the kernels' plain versions.

Counterpart of ``tests/test_parallel.py``. Each case runs once split over
the ranks and is held against

- the port's single-process run: float logits and losses within 1e-6 (the
  CPU convs sum in another blocking for another block height), the halo
  conv's and the trainer's gradients within 1e-5, the params after training
  within 1e-4 of their update, int8 logits and label maps equal;
- the JAX package's single-device run, at the reference's bars: 1e-5 for
  the halo conv and the float forward, rtol 2e-4 for training losses, and
  for one int8 step ``tests/test_torch_quant.py``'s ``FRAME_BAR``.

The ranks run in processes started by ``parallel.run_ranks`` (spawned, a
``file://`` rendezvous under the test's tmp dir, a timeout on every join):
two sessions, one of 2 ranks and one of 4, each running several cases, whose
results the tests below read; both start with the module's first test and
run beside its single-process and JAX runs. The ranks import this module,
so JAX is imported inside the tests, never at the top.
"""

import os
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from lstm_unet_tpu_torch.checkpoint.convert import params_to_jax
from lstm_unet_tpu_torch.config import CTCParams, InferenceParams, tiny_net_kernel_params
from lstm_unet_tpu_torch.engine import infer
from lstm_unet_tpu_torch.engine.train import Trainer
from lstm_unet_tpu_torch.io import synthetic
from lstm_unet_tpu_torch.io.tiff import read_tiff
from lstm_unet_tpu_torch.models import ModelConfig, ULSTMnet2D, quantize_model_int8
from lstm_unet_tpu_torch.ops.kernels import counts, reset_counts
from lstm_unet_tpu_torch.parallel import (distributed, halo_conv2d, initialize, make_mesh,
                                          plan_split, run_ranks)
from lstm_unet_tpu_torch.parallel.comm import all_reduce_
from lstm_unet_tpu_torch.parallel.mesh import mesh_layout

HERE = os.path.dirname(os.path.abspath(__file__))
TORCH_CKPT = os.path.join(HERE, "golden", "torch_ckpt")
GOLDEN_DATA = dict(num_frames=8, height=32, width=32, num_cells=3, seed=123)
FRAME_BAR = 2.0 ** -5  # tests/test_torch_quant.py: one int8 step against the reference
B, T, HW = 4, 2, 32  # the sharded forward (reference: test_parallel.py:33)
SESSION_TIMEOUT_S = 150.0


# ---------------------------------------------------------------- inputs


def _frames():
    return np.random.default_rng(1).normal(size=(B, T, HW, HW, 1)).astype(np.float32)


def _model(quant=False, **kw):
    """The tiny model with weights from torch seed 0 (f32; int8: the same
    weights quantized, bf16 compute, dynamic scales); ``kw`` to its config."""
    if quant:
        kw.update(dtype="bfloat16", quant="int8")
    model = ULSTMnet2D(ModelConfig.make(tiny_net_kernel_params(), **kw),
                       generator=torch.Generator().manual_seed(0))
    if quant:
        quantize_model_int8(model, float_dtype=torch.bfloat16)
    return model


def _halo_inputs():
    """x [2, 32, 24, 8], a 5x3 OIHW kernel 8 -> 16, its bias and the
    cotangent of the output (reference: test_parallel.py:77-79)."""
    g = np.random.default_rng(0)
    return (g.normal(size=(2, 32, 24, 8)).astype(np.float32),
            g.uniform(-0.2, 0.2, (16, 8, 5, 3)).astype(np.float32),
            g.uniform(-0.2, 0.2, 16).astype(np.float32),
            g.normal(size=(2, 32, 24, 16)).astype(np.float32))


def _gate_cell():
    """An int8 ConvLSTM cell the gate epilogue takes (5x5, 8 -> F = 64) and
    its inputs x [2, 32, 24, 8], h and c [2, 32, 24, 64]."""
    from lstm_unet_tpu_torch.ops.convlstm import ConvLSTMCell, QConvLSTMCell

    g = np.random.default_rng(4)
    qc = QConvLSTMCell(ConvLSTMCell(5, 8, 64, generator=torch.Generator().manual_seed(4)))
    return qc, [torch.from_numpy(g.normal(0, s, (2, 32, 24, n)).astype(np.float32))
                for s, n in ((1.0, 8), (0.5, 64), (1.5, 64))]


def _halo_conv(x, k, b, r, group=None, rows=slice(None)):
    """(y, dy/dx, dy/dk, dy/db) of ``sum(conv(x) * r)`` on ``x``'s rows."""
    xt = torch.from_numpy(x[:, rows]).requires_grad_()
    kt, bt = torch.from_numpy(k).requires_grad_(), torch.from_numpy(b).requires_grad_()
    y = halo_conv2d(xt, kt, bt, group=group)
    (y * torch.from_numpy(r[:, rows])).sum().backward()
    return y.detach(), xt.grad, kt.grad, bt.grad


def _train_params(root, mesh_shape, **kw):
    """The reference test's CTCParams (test_parallel.py:98-105), ``kw`` over them."""
    return CTCParams(**dict(dict(
        root_data_dir=root, train_sequence_list=[("Synth-N2DH-SIM", "01")],
        val_sequence_list=[("Synth-N2DH-SIM", "01")],
        crop_size=(32, 32), batch_size=2, unroll_len=2,
        net_kernel_params=tiny_net_kernel_params(), learning_rate=1e-3, dry_run=True,
        num_prefetch_threads=1, validation_interval=10 ** 6,
        save_checkpoint_iteration=10 ** 6, print_to_console_interval=10 ** 6,
        write_to_tb_interval=10 ** 6, mesh_shape=mesh_shape), **kw))


def _losses(trainer, steps=4):
    """The reference test's loop (test_parallel.py:121-131): ``steps`` train
    steps from a fresh state, their losses; then one validation batch, its
    metrics. Also what the first update was made from, the gradients the
    optimizer got (all-reduced, under a mesh), and the params after the
    last step."""
    out, grads, opt_step = [], {}, trainer.optimizer.step

    def recording(params, g):
        if not grads:
            grads.update({k: v.detach().numpy().copy() for k, v in g.items()})
        return opt_step(params, g)

    trainer.optimizer.step = recording
    trainer.reader.start_queues()
    trainer.val_reader.start_queues()
    state = trainer._fresh_state()
    try:
        for _ in range(steps):
            state, m = trainer.step_fn(state, *trainer._put(trainer.reader.get_batch()))
            out.append(float(m["loss"]))
        trainer._validate(trainer._fresh_state())
    finally:
        trainer.reader.stop()
        trainer.val_reader.stop()
    return dict(losses=out, val=trainer.last_val_metrics, grads=grads,
                params=_params(trainer.model))


def _params(model):
    return {k: v.detach().numpy().copy() for k, v in model.named_parameters()}


def _stream_params(mesh_shape=None, **kw):
    return InferenceParams(model_path=TORCH_CKPT, dtype="float32", min_cell_size=5,
                           pre_sequence_frames=2, mesh_shape=mesh_shape or {}, **kw)


def _masks(d):
    names = sorted(n for n in os.listdir(d) if n.endswith(".tif"))
    return names, [read_tiff(os.path.join(d, n)) for n in names]


_WRITE_EVENTS = ("os.mkdir", "os.rename", "os.remove", "os.rmdir", "shutil.rmtree",
                 "shutil.copyfile")


def _record_writes(root, into):
    """An audit hook that records every file this process opens for writing,
    and every directory it makes or file it renames or removes, under
    ``root``."""
    root = os.path.realpath(root)

    def hook(event, args):
        if event == "open":
            path, mode, flags = args
            writes = (any(c in mode for c in "wax+") if isinstance(mode, str)
                      else bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT)))
        elif event in _WRITE_EVENTS:
            path, writes = args[0], True
        else:
            return
        if writes and isinstance(path, (str, bytes, os.PathLike)) and os.path.realpath(
                os.fsdecode(path)).startswith(root):
            into.append((event, os.fsdecode(path)))

    sys.addaudithook(hook)


def _blind_to(root):
    """An audit hook that makes every file and directory listing under
    ``root`` unreadable to this process, as on a host that does not share
    the filesystem of the rank that writes them."""
    root = os.path.realpath(root)

    def hook(event, args):
        if event in ("open", "os.listdir", "os.scandir") and isinstance(
                args[0], (str, bytes, os.PathLike)) and os.path.realpath(
                    os.fsdecode(args[0])).startswith(root):
            raise FileNotFoundError(f"{args[0]} is on another host's filesystem")

    sys.addaudithook(hook)


# ---------------------------------------------------------------- the ranks


def _pair_session(rank, dev, root, seq, seqs):
    """2 ranks: the halo conv and the int8 cell's gate route (dynamic
    scales) under {'spatial': 2}; one step of the model
    with bilinear upsampling under {'spatial': 2}; a TTA 'flip' stream under
    {'spatial': 2}; a 4-lane batched stream under {'data': 2}; a training
    run under {'data': 2} that saves and rolls back a spike, then a
    fine-tune seeded from it, with every write of rank 1 recorded and every
    read of rank 1 under the runs dir refused."""
    torch.set_num_threads(2)
    out = {}
    mesh = make_mesh({"spatial": 2})
    split = plan_split(mesh, 2, 32, 0)
    x, k, b, r = _halo_inputs()
    rows = split.row_slice(32)
    y, gx, gk, gb = _halo_conv(x, k, b, r, split.spatial, rows)
    out["halo"] = (split.gather(y, row_dim=1).numpy(),
                   split.gather(gx, row_dim=1).numpy(),
                   all_reduce_(gk, "sum", split.spatial).numpy(),
                   all_reduce_(gb, "sum", split.spatial).numpy())

    qc, (x, h, c) = _gate_cell()
    reset_counts()
    with torch.no_grad():
        (h, c), _ = qc((h[:, rows].contiguous(), c[:, rows].contiguous()),
                       x[:, rows].contiguous(), split=split)
    out["gates"] = (split.gather(h, row_dim=1).numpy(), split.gather(c, row_dim=1).numpy(),
                    counts()["conv2d_int8_wgmma_gates"])

    model = _model(upsample="bilinear")
    split = model.split = plan_split(mesh, 2, HW, 2)
    with torch.no_grad():
        x = torch.from_numpy(np.ascontiguousarray(split.take(_frames()[:2, 0], 0, 1)))
        _, logits = model.step(model.init_state(*split.block(2, HW), HW), x)
    out["bilinear"] = split.gather(logits, row_dim=1).numpy()

    reset_counts()
    out["tta_n"] = infer.run_inference(
        _stream_params({"spatial": 2}, tta=True, sequence_path=seq,
                       output_path=os.path.join(root, f"tta_rank{rank}")), device=dev)
    out["tta_counts"] = counts()
    out["batched_n"] = infer.run_inference_batched(
        _stream_params({"data": 2}), seqs,
        [os.path.join(root, f"batched_rank{rank}", str(i)) for i in range(len(seqs))],
        device=dev)

    runs = os.path.join(root, "runs")
    writes = []
    if rank == 1:
        _record_writes(root, writes)
        _blind_to(runs)
    p = _train_params(os.path.join(root, "ctc"), {"data": 2}, dry_run=False,
                      root_save_dir=runs, save_checkpoint_iteration=2, write_to_tb_interval=1,
                      validation_interval=2,
                      async_checkpoint=True, spike_factor=5.0, spike_warmup=1,
                      spike_cooldown=1)
    trainer = Trainer(p, seed=3, device=dev)
    step_fn, seen = trainer.step_fn, [0]

    def spiking(*args):  # the loss of step 3 is 100x, on both ranks
        state, m = step_fn(*args)
        seen[0] += 1
        if seen[0] == 3:
            m = dict(m, loss=m["loss"] * 100)
        return state, m

    trainer.step_fn = spiking
    trainer.train(num_iterations=5)
    out["rollbacks"] = list(trainer.spike_guard.rollback_steps)
    out["val"] = trainer.last_val_metrics
    out["params"] = _params(trainer.model)
    out["run_dir"] = os.path.dirname(p.experiment_save_dir)
    tune = Trainer(_train_params(os.path.join(root, "ctc"), {"data": 2}, dry_run=False,
                                 root_save_dir=runs, experiment_name="tune",
                                 load_checkpoint=True, load_checkpoint_path=out["run_dir"]),
                   seed=4, device=dev)
    out["tune_from"] = tune.global_step
    tune.train(num_iterations=2)
    out["tune_step"], out["tune_params"] = tune.global_step, _params(tune.model)
    out["writes"] = writes
    return out


def _quad_session(rank, dev, root, x, x8):
    """4 ranks, {'data': 2, 'spatial': 2}: the float forward over a [4, 2,
    32, 32] window, one int8 step, and 4 train steps."""
    torch.set_num_threads(1)
    mesh = make_mesh({"data": 2, "spatial": 2})
    out = {}
    with torch.no_grad():
        model = _model()
        split = model.split = plan_split(mesh, B, HW, 2)
        xl = torch.from_numpy(np.ascontiguousarray(split.take(x, 0, 2)))
        _, logits = model.apply(model.init_state(*split.block(B, HW), HW), xl)
        out["forward"] = split.gather(logits, lane_dim=0, row_dim=2).numpy()

        qmodel = _model(quant=True)
        qmodel.split = split
        xl = torch.from_numpy(np.ascontiguousarray(split.take(x8, 0, 1)))
        _, logits = qmodel.step(qmodel.init_state(*split.block(B, HW), HW), xl)
        out["int8"] = split.gather(logits, lane_dim=0, row_dim=1).numpy()

    trainer = Trainer(_train_params(os.path.join(root, "ctc"), {"data": 2, "spatial": 2}),
                      seed=3, device=dev)
    split = trainer.model.split
    out["train_split"] = (split.lanes, split.rows, trainer._fresh_state()[0][0][0].shape)
    out.update(_losses(trainer))
    return out


# ---------------------------------------------------------------- sessions


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("mesh"))
    seq, _ = synthetic.write_ctc_dataset(os.path.join(root, "golden"), **GOLDEN_DATA)
    seqs = [synthetic.write_ctc_dataset(os.path.join(root, "sweep"), seq=f"0{i}",
                                        num_frames=5, height=32, width=32, num_cells=3,
                                        seed=seed)[0]
            for i, seed in enumerate((11, 12, 13, 14), start=1)]
    synthetic.write_ctc_dataset(os.path.join(root, "ctc"), num_frames=8, height=48,
                                width=48, num_cells=3, seed=11)
    return root, seq, seqs


@pytest.fixture(scope="module", autouse=True)
def sessions(data):
    """Both sessions, started at the module's first test and run beside the
    tests' single-process and JAX runs."""
    root, seq, seqs = data
    x = _frames()
    with ThreadPoolExecutor(2) as pool:
        yield {"pair": pool.submit(run_ranks, _pair_session, 2, (root, seq, seqs),
                                   device="cpu", timeout_s=SESSION_TIMEOUT_S, work_dir=root),
               "quad": pool.submit(run_ranks, _quad_session, 4, (root, x, x[:, 0]),
                                   device="cpu", timeout_s=SESSION_TIMEOUT_S, work_dir=root)}


@pytest.fixture(scope="module")
def pair(sessions):
    return sessions["pair"].result()


@pytest.fixture(scope="module")
def quad(sessions):
    return sessions["quad"].result()


# ---------------------------------------------------------------- set-up


def test_make_mesh_shapes():
    """Reference: test_parallel.py:22 (its 8 devices as 8 ranks)."""
    assert mesh_layout({"data": 4, "spatial": 2}, 8).tolist() == \
        [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert mesh_layout({"spatial": 2}, 2).shape == (2,)
    with pytest.raises(ValueError, match="needs 100 ranks"):
        mesh_layout({"data": 100}, 8)
    with pytest.raises(ValueError, match="uses 2 of the 8"):
        mesh_layout({"data": 2}, 8)
    with pytest.raises(ValueError, match="mesh_shape must be"):
        mesh_layout({"spatial": 2, "data": 2}, 4)


def test_a_mesh_needing_more_ranks_than_exist_raises(tmp_path):
    with pytest.raises(ValueError, match="needs 2 ranks, have 1"):
        make_mesh({"data": 2})
    with pytest.raises(ValueError, match="needs 4 ranks, have 1"):
        infer.StreamingInferenceEngine(_model(), _stream_params({"data": 2, "spatial": 2}),
                                       "cpu")
    assert make_mesh({}) is None and make_mesh({"data": 1}) is None


def test_initialize_is_a_noop_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()
    assert distributed.rank() == 0 and distributed.is_writer()
    assert distributed.backend_for(torch.device("cuda")) == "nccl"
    assert distributed.backend_for(torch.device("cuda:0")) == "gloo"
    assert distributed.backend_for(torch.device("cpu")) == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="nccl"):
            initialize("cuda", world_size=2, rank=0)
        with pytest.raises(RuntimeError, match="no CUDA GPU"):
            initialize("cuda")


def test_split_rules_are_the_references():
    """Lanes over 'data' when B divides and not under TTA; rows over
    'spatial' when H % (spatial * 2^depth) == 0 (engine/infer.py:421-432)."""

    class Mesh2x2:
        axis_names, shape = ("data", "spatial"), (2, 2)

        @staticmethod
        def axis_size(axis):
            return 2

    def plan(*a, **kw):
        s = plan_split(Mesh2x2(), *a, **kw)
        return None if s is None else (s.lanes, s.rows)

    assert plan(4, 32, 2) == (True, True)
    assert plan(3, 32, 2) == (False, True)
    assert plan(4, 36, 2) == (True, False)
    assert plan(3, 36, 2) is None
    assert plan(4, 32, 2, replicate_lanes=True) == (False, True)
    assert plan(4, 24, 2) == (True, True)  # 24 % (2 * 2^2) == 0
    assert plan(4, 24, 3) == (True, False) and plan(4, 48, 3) == (True, True)


# ---------------------------------------------------------------- the halo conv


def test_halo_conv_matches_unsharded(pair):
    """Reference: test_parallel.py:71, and the gradients of the exchange's
    backward, against the unsharded conv and JAX's halo_conv2d."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from lstm_unet_tpu.parallel import make_mesh as jax_make_mesh
    from lstm_unet_tpu.parallel.halo import halo_conv2d as jax_halo_conv2d

    x, k, b, r = _halo_inputs()
    want = [t.numpy() for t in _halo_conv(x, k, b, r)]
    for got in (o["halo"] for o in pair):
        # y and dy/dx within 1e-5 (a boundary row's dy/dx is two partial sums
        # added: measured 2.9e-6); the weight and bias grads, sums over every
        # pixel of the ranks' partial sums, within 1e-5 of their largest
        # magnitude (measured 1e-6), as tests/test_torch_train.py holds grads
        for g, w, scale in zip(got, want, (1, 1, np.abs(want[2]).max(),
                                           np.abs(want[3]).max())):
            assert np.abs(g - w).max() <= 1e-5 * scale

    jmesh = jax_make_mesh({"spatial": 2})
    kj, bj, rj = jnp.asarray(k.transpose(2, 3, 1, 0)), jnp.asarray(b), jnp.asarray(r)

    def loss(xx, kk, bb):
        y = jax_halo_conv2d(xx, kk, bb, mesh=jmesh)
        return jnp.sum(y * rj), y

    xs = jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P(None, "spatial")))
    (_, y), (gx, gk, gb) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        xs, kj, bj)
    ref = (np.asarray(y), np.asarray(gx), np.asarray(gk).transpose(3, 2, 0, 1),
           np.asarray(gb))
    for g, w, scale in zip(pair[0]["halo"], ref, (1, 1, np.abs(ref[2]).max(),
                                                  np.abs(ref[3]).max())):
        assert np.abs(g - w).max() <= 1e-5 * scale


def test_int8_gate_route_under_spatial_mesh_matches_single_process(pair):
    """The int8 cell's gate route under {'spatial': 2} (h's 2 halo rows
    exchanged, gx and c with zero rows, the new state cropped; the dynamic
    scales all-reduced): each rank's rows, gathered, equal one process's
    bit for bit, one launch a rank."""
    qc, (x, h, c) = _gate_cell()
    assert qc.wh.gates
    with torch.no_grad():
        (want_h, want_c), _ = qc((h, c), x)
    for o in pair:
        np.testing.assert_array_equal(o["gates"][0], want_h.numpy())
        np.testing.assert_array_equal(o["gates"][1], want_c.numpy())
        assert o["gates"][2] == {"kernel": 0, "plain": 1}


# ---------------------------------------------------------------- forward


def test_bilinear_upsample_under_spatial_mesh_matches_single_process(pair):
    """Bilinear upsampling needs a row of each neighbour (the nearest one the
    models default to needs none): the split step equals one process's."""
    model = _model(upsample="bilinear")
    with torch.no_grad():
        _, want = model.step(model.init_state(2, HW, HW), torch.from_numpy(_frames()[:2, 0]))
    for o in pair:
        np.testing.assert_allclose(o["bilinear"], want.numpy(), atol=1e-6)


def test_sharded_forward_matches_single_device(quad):
    """Reference: test_parallel.py:30, on a {'data': 2, 'spatial': 2} mesh."""
    import jax
    import jax.numpy as jnp
    from lstm_unet_tpu.config import tiny_net_kernel_params as jax_tiny
    from lstm_unet_tpu.models import ModelConfig as JaxConfig
    from lstm_unet_tpu.models import ULSTMnet2D as JaxNet

    model, x = _model(), _frames()
    with torch.no_grad():
        _, want = model.apply(model.init_state(B, HW, HW), torch.from_numpy(x))
    for o in quad:
        np.testing.assert_allclose(o["forward"], want.numpy(), atol=1e-6)

    jcfg = JaxConfig.make(jax_tiny())
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(model.state_dict()))
    _, ref = jax.jit(lambda p, st, xx: JaxNet.apply(p, st, xx, jcfg))(
        params, JaxNet.init_state(jcfg, B, HW, HW), jnp.asarray(x))
    np.testing.assert_allclose(quad[0]["forward"], np.asarray(ref), atol=1e-5)


def test_int8_sharded_forward_matches_single_device(quad):
    """Reference: test_parallel.py:142. Dynamic scales are one abs-max over
    the whole [B, H, W, C] tensor: each rank's is all-reduced with MAX, so
    the sharded int8 step equals the single-process one."""
    import jax
    import jax.numpy as jnp
    from lstm_unet_tpu.config import tiny_net_kernel_params as jax_tiny
    from lstm_unet_tpu.models import ModelConfig as JaxConfig
    from lstm_unet_tpu.models import ULSTMnet2D as JaxNet
    from lstm_unet_tpu.ops.quant import quantize_params_int8

    x8 = _frames()[:, 0]
    qmodel = _model(quant=True)
    with torch.no_grad():
        _, want = qmodel.step(qmodel.init_state(B, HW, HW), torch.from_numpy(x8))
    for o in quad:
        np.testing.assert_array_equal(o["int8"], want.numpy())

    jcfg = JaxConfig.make(jax_tiny(), dtype="bfloat16", quant="int8")
    params = jax.tree_util.tree_map(jnp.asarray, params_to_jax(_model().state_dict()))
    qparams = quantize_params_int8(params, float_dtype=jnp.bfloat16)
    _, ref = jax.jit(lambda p, st, xx: JaxNet.step(p, st, xx, jcfg))(
        qparams, JaxNet.init_state(jcfg, B, HW, HW), jnp.asarray(x8))
    ref = np.asarray(ref)
    assert np.abs(quad[0]["int8"] - ref).max() / np.abs(ref).max() < FRAME_BAR


# ---------------------------------------------------------------- training


def test_trainer_dp_sp_mesh_matches_single_device(quad, data):
    """Reference: test_parallel.py:86, 4 steps on {'data': 2, 'spatial': 2}
    (32 % (2 * 2^2) == 0: the state's rows really split), against the port's
    single-process trainer (losses, the first step's gradients, the params
    after the last step) and the JAX trainer's losses from the same
    weights."""
    import jax
    import jax.numpy as jnp
    from lstm_unet_tpu.config import CTCParams as JaxParams
    from lstm_unet_tpu.config import tiny_net_kernel_params as jax_tiny
    from lstm_unet_tpu.engine.train import Trainer as JaxTrainer

    assert quad[0]["train_split"] == (True, True, (1, 16, 32, 8))
    single = Trainer(_train_params(os.path.join(data[0], "ctc"), {"data": 1}), seed=3,
                     device="cpu")
    jp = _train_params(os.path.join(data[0], "ctc"), {})
    jt = JaxTrainer(JaxParams(**{k: getattr(jp, k) for k in (
        "root_data_dir", "train_sequence_list", "crop_size", "batch_size", "unroll_len",
        "learning_rate", "dry_run", "num_prefetch_threads", "validation_interval",
        "save_checkpoint_iteration", "print_to_console_interval", "write_to_tb_interval",
        "mesh_shape")}, net_kernel_params=jax_tiny()), seed=3)
    jt.model_params = jax.tree_util.tree_map(jnp.asarray,
                                             params_to_jax(single.model.state_dict()))
    jt.opt_state = jt.optimizer.init(jt.model_params)
    ref = []
    jt.reader.start_queues()
    state = jt._fresh_state()
    try:
        for _ in range(4):
            (jt.model_params, jt.opt_state, state, m) = jt.step_fn(
                jt.model_params, jt.opt_state, state, *jt._put(jt.reader.get_batch()))
            ref.append(float(m["loss"]))
    finally:
        jt.reader.stop()
    p0 = _params(single.model)
    want = _losses(single)
    for o in quad:
        # losses within 1e-6 (measured 7.8e-8); what the first update was made
        # from, the all-reduced gradients, within 1e-5 of each leaf's largest
        # magnitude (measured 1.5e-6): a missing or mis-scaled all-reduce over
        # 'data', or a halo gradient dropped, moves them far more, and the
        # losses far less; the params after 4 steps within 1e-4 of each leaf's
        # largest update (Adam divides by the gradients' own size: measured
        # 1.4e-5)
        np.testing.assert_allclose(o["losses"], want["losses"], rtol=1e-6)
        for k, w in want["grads"].items():
            assert np.abs(o["grads"][k] - w).max() <= 1e-5 * np.abs(w).max(), k
        for k, w in want["params"].items():
            assert np.abs(o["params"][k] - w).max() <= 1e-4 * np.abs(w - p0[k]).max(), k
        # validation: the whole batch's metrics, its probs gathered for SEG/DET
        assert o["val"].keys() == want["val"].keys()
        for k, v in want["val"].items():
            assert o["val"][k] == pytest.approx(v, rel=1e-6, abs=1e-7), k
    np.testing.assert_allclose(quad[0]["losses"], ref, rtol=2e-4)


def test_rank_one_writes_nothing(pair):
    """Checkpoints, target_step.json, the params JSON, TensorBoard: rank 0
    alone writes them, also across a spike rolled back to a checkpoint."""
    r0, r1 = pair
    assert r0["rollbacks"] == r1["rollbacks"] == [3]
    assert r0["val"] == r1["val"] and np.isfinite(list(r0["val"].values())).all()
    assert r1["writes"] == []
    assert [r["tune_from"] for r in pair] == [5, 5]  # the fine-tune's seed: the last save
    assert [r["tune_step"] for r in pair] == [7, 7]
    run = r0["run_dir"]
    assert sorted(os.listdir(os.path.join(run, "ckpt"))) == [
        "2", "4", "5", "model_params.json", "target_step.json", "train_params.json"]
    logs = os.path.join(run, "logs")
    assert not os.path.isdir(logs) or all(n.startswith("events") for n in os.listdir(logs))


def test_rank_one_restores_what_rank_zero_read(pair):
    """Rank 1 reads no file of the run (it raises on any; a host without the
    writer's filesystem): the spike rollback and the seeded fine-tune restore
    the params and moments rank 0 read, so both ranks hold the same params
    after each, bit for bit."""
    r0, r1 = pair
    for key in ("params", "tune_params"):
        assert r0[key].keys() == r1[key].keys()
        for k in r0[key]:
            np.testing.assert_array_equal(r1[key][k], r0[key][k], err_msg=k)


# ---------------------------------------------------------------- streams


def _jax_stream(seqs, outs, **kw):
    """The JAX package's batched stream of the golden checkpoint."""
    from lstm_unet_tpu.config import CTCInferenceParams
    from lstm_unet_tpu.engine.infer import run_inference_batched as jax_batched

    return jax_batched(CTCInferenceParams(
        model_path=os.path.join(HERE, "golden", "ckpt"), dtype="float32", min_cell_size=5,
        pre_sequence_frames=2, **kw), seqs, outs)


def test_batched_stream_under_data_mesh_writes_the_single_process_masks(pair, data):
    """And the masks of the JAX package's batched run."""
    root, _, seqs = data
    want_dirs = [os.path.join(root, "batched_single", str(i)) for i in range(len(seqs))]
    jax_dirs = [os.path.join(root, "batched_jax", str(i)) for i in range(len(seqs))]
    n = infer.run_inference_batched(_stream_params(), seqs, want_dirs, device="cpu")
    assert _jax_stream(seqs, jax_dirs) == n
    assert [o["batched_n"] for o in pair] == [n, 0] and n == 4 * 5
    for i, (want_dir, jax_dir) in enumerate(zip(want_dirs, jax_dirs)):
        names, want = _masks(want_dir)
        got_names, got = _masks(os.path.join(root, "batched_rank0", str(i)))
        assert got_names == names == _masks(jax_dir)[0] and len(names) == 5
        for g, w, j in zip(got, want, _masks(jax_dir)[1]):
            np.testing.assert_array_equal(g, w)
            np.testing.assert_array_equal(g, j)
    assert not os.path.exists(os.path.join(root, "batched_rank1"))


def test_tta_stream_under_spatial_mesh_writes_the_single_process_masks(pair, data):
    """And the masks of the JAX package's TTA stream."""
    root, seq, _ = data
    n = infer.run_inference(_stream_params(tta=True, sequence_path=seq,
                                           output_path=os.path.join(root, "tta_single")),
                            device="cpu")
    assert _jax_stream([seq], [os.path.join(root, "tta_jax")], tta=True) == n
    assert [o["tta_n"] for o in pair] == [n, 0] and n == GOLDEN_DATA["num_frames"]
    names, want = _masks(os.path.join(root, "tta_single"))
    got_names, got = _masks(os.path.join(root, "tta_rank0"))
    assert got_names == names == _masks(os.path.join(root, "tta_jax"))[0]
    for g, w, j in zip(got, want, _masks(os.path.join(root, "tta_jax"))[1]):
        np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(g, j)
    assert not os.path.exists(os.path.join(root, "tta_rank1"))
    # K3 once a frame, on rank 0 only (the other rank holds the same lane)
    ccl = [o["tta_counts"]["ccl"]["plain"] for o in pair]
    assert ccl == [n + 2, 0]  # + the 2 warm-up frames
