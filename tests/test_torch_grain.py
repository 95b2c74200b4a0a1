"""The port's deterministic provider against the JAX reference's
``GrainCTCReaderSequence2D``, on the CPU.

The same CTC files, params and seed: ``make_batch(step)`` must be
bit-identical for steps 0-20 (2 lanes, with and without instance GT), the
stream after ``set_start_step(7)`` must equal steps 7-20, and the port must
run with no ``grain`` package.
"""

import sys

import numpy as np
import pytest

from lstm_unet_tpu.config import CTCParams as JaxCTCParams
from lstm_unet_tpu.io.grain_reader import GrainCTCReaderSequence2D as JaxGrain
from lstm_unet_tpu_torch.config import CTCParams, tiny_net_kernel_params
from lstm_unet_tpu_torch.io.grain_reader import GrainCTCReaderSequence2D
from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset


@pytest.fixture(scope="module")
def ctc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, seq="01", num_frames=10, height=32, width=40, num_cells=3,
                      seed=4)
    write_ctc_dataset(root, seq="02", num_frames=7, height=32, width=40, num_cells=4,
                      seed=5)
    return root


def _params(root, cls, **kw):
    d = dict(root_data_dir=root, crop_size=(24, 24), batch_size=2, unroll_len=3,
             dry_run=True, train_sequence_list=[("Synth-N2DH-SIM", "01"),
                                                ("Synth-N2DH-SIM", "02")],
             data_provider_class="GrainCTCReaderSequence2D")
    d.update(kw)
    if cls is CTCParams:
        d["net_kernel_params"] = tiny_net_kernel_params()
    return cls(**d)


def _equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("instances", [False, True])
def test_make_batch_bit_identical_to_jax(ctc_root, instances):
    port = GrainCTCReaderSequence2D(_params(ctc_root, CTCParams), seed=3,
                                    return_instances=instances)
    ref = JaxGrain(_params(ctc_root, JaxCTCParams), seed=3, return_instances=instances)
    saw_last = False
    for step in range(21):
        got = port.make_batch(step)
        _equal(got, ref.make_batch(step))
        saw_last |= bool(got[4].any())
    assert saw_last  # the steps cross sequence ends


def test_stream_resumes_at_the_start_step(ctc_root, monkeypatch):
    """``set_start_step(7)`` then ``get_batch`` through the prefetch thread:
    steps 7-20 of a fresh reader's ``make_batch``, with no grain package."""
    monkeypatch.setitem(sys.modules, "grain", None)
    monkeypatch.setitem(sys.modules, "grain.python", None)
    reader = GrainCTCReaderSequence2D(_params(ctc_root, CTCParams), seed=3)
    reader.set_start_step(7)
    reader.start_queues()
    try:
        got = [reader.get_batch() for _ in range(14)]
    finally:
        reader.stop()
    fresh = GrainCTCReaderSequence2D(_params(ctc_root, CTCParams), seed=3)
    for step, batch in zip(range(7, 21), got):
        _equal(batch, fresh.make_batch(step))
    # a restart begins again at the start step
    reader.start_queues()
    try:
        _equal(reader.get_batch(), fresh.make_batch(7))
    finally:
        reader.stop()


def test_stream_equals_the_reference_stream(ctc_root):
    """Both providers' ``get_batch`` streams from step 4 (the reference's
    through grain's prefetch)."""
    port = GrainCTCReaderSequence2D(_params(ctc_root, CTCParams), seed=9)
    ref = JaxGrain(_params(ctc_root, JaxCTCParams), seed=9)
    for r in (port, ref):
        r.set_start_step(4)
        r.start_queues()
    try:
        for _ in range(6):
            _equal(port.get_batch(), ref.get_batch())
    finally:
        port.stop()
        ref.stop()


def test_producer_errors_reach_get_batch(ctc_root):
    reader = GrainCTCReaderSequence2D(_params(ctc_root, CTCParams), seed=3)

    def boom(step):
        raise OSError("disk gone")

    reader.make_batch = boom
    reader.start_queues()
    try:
        with pytest.raises(OSError, match="disk gone"):
            reader.get_batch()
    finally:
        reader.stop()
