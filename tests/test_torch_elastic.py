"""The port's elastic augmentation against the JAX reference's, on the CPU.

The reference warps with ``cv2.warpAffine``; the port with numpy (no cv2).
The draws of each traversal, affine matrix included, are bit-equal. The
warps agree to 2e-4 on the image (cv2 samples at float coordinates; the
numpy bilinear weights in float64 differ from cv2's by up to ~1e-4 on
values up to ~3) and to 3 label pixels per 32² frame (coordinates that round
the other way at a half pixel); the rest of a batch is bit-equal.
"""

import numpy as np
import pytest

from lstm_unet_tpu.config import CTCParams as JaxCTCParams
from lstm_unet_tpu.io.dataset import CTCRAMReaderSequence2D as JaxReader
from lstm_unet_tpu_torch.config import CTCParams, tiny_net_kernel_params
from lstm_unet_tpu_torch.io.dataset import CTCRAMReaderSequence2D
from lstm_unet_tpu_torch.io.synthetic import write_ctc_dataset

IMG_ATOL = 2e-4
LABEL_PX = 3  # per frame


@pytest.fixture(scope="module")
def ctc_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("ctc"))
    write_ctc_dataset(root, seq="01", num_frames=9, height=40, width=40, num_cells=4,
                      seed=6)
    write_ctc_dataset(root, seq="02", num_frames=6, height=32, width=48, num_cells=3,
                      seed=7)
    return root


def _both(root, **kw):
    d = dict(root_data_dir=root, crop_size=(32, 32), batch_size=2, unroll_len=4,
             dry_run=True, elastic_augmentation=True,
             train_sequence_list=[("Synth-N2DH-SIM", "01"), ("Synth-N2DH-SIM", "02")])
    d.update(kw)
    return (CTCParams(net_kernel_params=tiny_net_kernel_params(), **d),
            JaxCTCParams(**d))


def test_traversal_draws_bit_equal_to_jax(ctc_root):
    port_p, jax_p = _both(ctc_root)
    port, ref = CTCRAMReaderSequence2D(port_p), JaxReader(jax_p)
    rp, rj = np.random.default_rng(11), np.random.default_rng(11)
    for _ in range(50):
        (s1, a1), (s2, a2) = port._new_traversal(rp), ref._new_traversal(rj)
        assert s1.name == s2.name and sorted(a1) == sorted(a2)
        for k in a1:
            if k == "affine":
                assert a1[k].dtype == a2[k].dtype == np.float32
                np.testing.assert_array_equal(a1[k], a2[k])
            else:
                assert a1[k] == a2[k], k
    # the RNG streams stay in step after the extra draws
    assert rp.integers(1 << 30) == rj.integers(1 << 30)


def test_no_affine_draw_without_randomize(ctc_root):
    port_p, _ = _both(ctc_root, randomize=False)
    s, aug = CTCRAMReaderSequence2D(port_p)._new_traversal(np.random.default_rng(0))
    assert aug["affine"] is None


def _labels_close(got, want):
    assert got.dtype == want.dtype == np.int32
    per_frame = (got != want).reshape(got.shape[0], -1).sum(1)
    assert per_frame.max() <= LABEL_PX, per_frame


@pytest.mark.parametrize("seed", range(6))
def test_apply_affine_matches_cv2(seed):
    r = np.random.default_rng(seed)
    ang, scale, shear = r.uniform(-10, 10), r.uniform(0.9, 1.1), r.uniform(-0.05, 0.05)
    a = np.deg2rad(ang)
    m = np.array([[np.cos(a) * scale, -np.sin(a) + shear, 0.0],
                  [np.sin(a) + shear, np.cos(a) * scale, 0.0]], np.float32)
    img = (r.random((3, 32, 32)) * 3).astype(np.float32)
    seg = r.integers(0, 3, (3, 4, 4)).repeat(8, 1).repeat(8, 2).astype(np.int32)
    inst = r.integers(0, 900, (3, 8, 8)).repeat(4, 1).repeat(4, 2).astype(np.int32)
    got = CTCRAMReaderSequence2D._apply_affine(img, seg, m, inst)
    want = JaxReader._apply_affine(img, seg, m, inst)
    assert got[0].dtype == np.float32 and got[0].shape == img.shape
    np.testing.assert_allclose(got[0], want[0], atol=IMG_ATOL, rtol=0)
    _labels_close(got[1], want[1])
    _labels_close(got[2], want[2])


@pytest.mark.parametrize("instances", [False, True])
def test_reader_batches_match_jax(ctc_root, instances):
    port_p, jax_p = _both(ctc_root)
    got, want = [], []
    for reader, out in ((CTCRAMReaderSequence2D(port_p, num_threads=1, seed=5,
                                                return_instances=instances), got),
                        (JaxReader(jax_p, num_threads=1, seed=5,
                                   return_instances=instances), want)):
        reader.start_queues()
        try:
            out.extend(reader.get_batch() for _ in range(6))
        finally:
            reader.stop()
    for g, w in zip(got, want):
        assert len(g) == len(w) == (6 if instances else 5)
        np.testing.assert_allclose(g[0], w[0], atol=IMG_ATOL, rtol=0)
        for k in (2, 3, 4):  # valid, full_seg, is_last
            np.testing.assert_array_equal(g[k], w[k])
        for k in ((1, 5) if instances else (1,)):
            b, t = g[k].shape[:2]
            _labels_close(g[k].reshape(b * t, *g[k].shape[2:]),
                          w[k].reshape(b * t, *w[k].shape[2:]))
