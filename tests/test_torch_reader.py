"""The port's training reader and GT preprocessing against the JAX reference.

The same CTC files (written by the port's ``write_ctc_dataset``) and the same
params and seed go through both readers; their batches must be bit-identical,
for any producer thread count.
"""

import os

import numpy as np
import pytest

from lstm_unet_tpu.config import CTCParams as JaxCTCParams
from lstm_unet_tpu.io.dataset import CTCRAMReaderSequence2D as JaxReader
from lstm_unet_tpu.io.preprocess import instance_to_three_class as jax_three_class
from lstm_unet_tpu.io.preprocess import instance_to_three_class_jax
from lstm_unet_tpu_torch.config import CTCParams, tiny_net_kernel_params
from lstm_unet_tpu_torch.io.dataset import CTCRAMReaderSequence2D, load_ctc_sequence
from lstm_unet_tpu_torch.io.preprocess import instance_to_three_class
from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset
from lstm_unet_tpu_torch.io.tiff import write_tiff


@pytest.fixture(scope="module")
def ctc_root(tmp_path_factory):
    """Two simulated sequences of different lengths and a real-style one
    (partial gold truth every other frame, silver truth on every frame)."""
    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, seq="01", num_frames=9, height=32, width=40,
                      num_cells=3, seed=1)
    write_ctc_dataset(root, seq="02", num_frames=6, height=32, width=40,
                      num_cells=4, seed=2)
    write_ctc_dataset(root, dataset="Real-N2DH", seq="01", annotate_every=2,
                      num_frames=7, height=32, width=32, num_cells=3, seed=3)
    st_dir = os.path.join(root, "Real-N2DH", "01_ST", "SEG")
    os.makedirs(st_dir)
    r = np.random.default_rng(0)
    for t in range(7):
        write_tiff(os.path.join(st_dir, f"man_seg{t:03d}.tif"),
                   r.integers(0, 4, (32, 32)).astype(np.uint16))
    return root


_SEQS = [("Synth-N2DH-SIM", "01"), ("Synth-N2DH-SIM", "02"), ("Real-N2DH", "01")]


def _both(root, **kw):
    common = dict(root_data_dir=root, train_sequence_list=_SEQS, crop_size=(24, 24),
                  batch_size=3, unroll_len=4, dry_run=True)
    common.update(kw)
    port = CTCParams(net_kernel_params=tiny_net_kernel_params(), **common)
    return port, JaxCTCParams(**common)


def _batches(reader, n):
    reader.start_queues()
    try:
        return [reader.get_batch() for _ in range(n)]
    finally:
        reader.stop()


@pytest.mark.parametrize("threads", [1, 2])
@pytest.mark.parametrize("instances", [False, True])
def test_reader_batches_bit_identical_to_jax(ctc_root, threads, instances):
    port_p, jax_p = _both(ctc_root)
    got = _batches(CTCRAMReaderSequence2D(port_p, num_threads=threads, seed=5,
                                          return_instances=instances), 7)
    want = _batches(JaxReader(jax_p, num_threads=1, seed=5,
                              return_instances=instances), 7)
    saw_last = saw_invalid = False
    for g, w in zip(got, want):
        assert len(g) == len(w) == (6 if instances else 5)
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
        saw_last |= bool(g[4].any())
        saw_invalid |= bool((g[2] == 0).any())
    assert saw_last and saw_invalid  # sequence ends and padded/unlabelled frames


@pytest.mark.parametrize("crop,randomize", [((32, 24), True), ((24, 24), False)])
def test_reader_options_bit_identical_to_jax(ctc_root, crop, randomize):
    """A non-square crop (no rot90) and ``randomize=False``."""
    port_p, jax_p = _both(ctc_root, crop_size=crop, randomize=randomize)
    got = _batches(CTCRAMReaderSequence2D(port_p, seed=9), 5)
    want = _batches(JaxReader(jax_p, seed=9), 5)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def test_load_ctc_sequence_matches_jax(ctc_root):
    from lstm_unet_tpu.io.dataset import load_ctc_sequence as jax_load

    for ds, sq in _SEQS:
        for full in (None, True):
            a = load_ctc_sequence(ctc_root, ds, sq, full, keep_instances=True)
            b = jax_load(ctc_root, ds, sq, full, keep_instances=True)
            for name in ("images", "seg", "valid", "full_seg", "inst"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
            assert a.name == b.name
    real = load_ctc_sequence(ctc_root, "Real-N2DH", "01")
    # gold truth (partial) on even frames wins over silver truth (full)
    np.testing.assert_array_equal(real.full_seg, np.arange(7) % 2 == 1)
    assert real.valid.all()


def test_reader_propagates_producer_errors(ctc_root):
    port_p, _ = _both(ctc_root)
    reader = CTCRAMReaderSequence2D(port_p, seed=0)

    def boom(*a, **k):
        raise RuntimeError("decode failed")

    reader._window = boom
    reader.start_queues()
    with pytest.raises(RuntimeError, match="decode failed"):
        reader.get_batch()
    reader.stop()


def test_reader_stop_drains_and_restarts_fresh(ctc_root):
    port_p, _ = _both(ctc_root)
    reader = CTCRAMReaderSequence2D(port_p, seed=3)
    first = _batches(reader, 2)
    again = _batches(reader, 2)  # restart: fresh traversals from the seed
    for g, w in zip(first, again):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)
    assert all(q.empty() for q in reader._lane_qs)


@pytest.mark.parametrize("seed", range(4))
def test_instance_to_three_class_bit_identical(seed):
    r = np.random.default_rng(seed)
    h, w = r.integers(5, 40, 2)
    labels = r.integers(0, 6, (h, w)).astype(np.uint16)
    labels[r.random((h, w)) < 0.3] = 0
    labels[: h // 2, : w // 2] = 7  # a solid block: interior pixels exist
    for bw in (1, 2):
        got = instance_to_three_class(labels, bw)
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, jax_three_class(labels, bw))
        np.testing.assert_array_equal(got, np.asarray(instance_to_three_class_jax(labels, bw)))
    assert set(np.unique(instance_to_three_class(labels))) <= {0, 1, 2}
    assert (instance_to_three_class(labels) == 1).any()
