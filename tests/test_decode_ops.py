"""Decode kernel, connected components, and regionprops tests."""

import numpy as np
import pytest
import scipy.ndimage

import jax.numpy as jnp

from merfish3d_tpu.ops import cc as cc_ops
from merfish3d_tpu.ops import decode as dec
from merfish3d_tpu.ops.filters import (
    downsample_image_anisotropic,
    gaussian_lowpass,
    replace_hot_pixels,
)


def _mhd4_codebook(n_genes=20, n_bits=16, seed=0):
    """Random 4-on-bit codewords with pairwise Hamming distance >= 4."""
    rng = np.random.default_rng(seed)
    words = []
    while len(words) < n_genes:
        w = np.zeros(n_bits, np.float32)
        w[rng.choice(n_bits, 4, replace=False)] = 1
        if all(np.sum(np.abs(w - u)) >= 4 for u in words):
            words.append(w)
    return np.stack(words)


def test_caller_thresholds_reference_values():
    # B=4: pixel sqrt(2-2*2/sqrt(8)), transcript sqrt(2-2*4/sqrt(24))
    pix, tr = dec.caller_thresholds(4)
    np.testing.assert_allclose(pix, np.sqrt(2 - 4 / np.sqrt(8)), rtol=1e-6)
    np.testing.assert_allclose(tr, np.sqrt(2 - 8 / np.sqrt(24)), rtol=1e-6)


def test_decode_exact_codewords():
    cb = _mhd4_codebook()
    n_bits = cb.shape[1]
    pix_thr, _ = dec.caller_thresholds(4)
    # build a volume where specific voxels carry exact codewords
    nz, ny, nx = 4, 16, 16
    vol = np.zeros((n_bits, nz, ny, nx), np.float32)
    truth = {}
    rng = np.random.default_rng(1)
    for i in range(10):
        g = rng.integers(0, len(cb))
        z, y, x = rng.integers(0, nz), rng.integers(2, ny - 2), rng.integers(2, nx - 2)
        vol[:, z, y, x] = cb[g] * 3.0  # magnitude 6 after scaling? -> see norms
        truth[(z, y, x)] = g
    background = np.zeros(n_bits, np.float32)
    normalization = np.ones(n_bits, np.float32)
    decoded, mag, dist, scaled = dec.decode_volume(
        vol, cb, background, normalization,
        magnitude_threshold=(1.5, 10.0), distance_threshold=pix_thr,
    )
    for (z, y, x), g in truth.items():
        assert decoded[z, y, x] == g, (z, y, x)
        assert dist[z, y, x] < 1e-3
    # zero voxels unassigned
    assert decoded[0, 0, 0] == -1


def test_decode_magnitude_gate():
    cb = _mhd4_codebook()
    n_bits = cb.shape[1]
    pix_thr, _ = dec.caller_thresholds(4)
    vol = np.zeros((n_bits, 1, 4, 4), np.float32)
    vol[:, 0, 1, 1] = cb[0] * 0.1  # magnitude 0.2 < 1.5 → rejected
    vol[:, 0, 2, 2] = cb[0] * 20.0  # magnitude 40 > 10 → rejected (clip makes mag 2)
    decoded, mag, dist, _ = dec.decode_volume(
        vol, cb, np.zeros(n_bits), np.ones(n_bits),
        magnitude_threshold=(1.5, 10.0), distance_threshold=pix_thr,
    )
    assert decoded[0, 1, 1] == -1
    # clip [0,1] caps per-bit at 1 → magnitude = 2 for a 4-on-bit word → assigned
    assert decoded[0, 2, 2] == 0


def test_decode_scaling_normalization():
    """(t - bg)/norm math: a voxel with per-bit intensities bg + norm*w
    decodes to w's codeword."""
    cb = _mhd4_codebook()
    n_bits = cb.shape[1]
    pix_thr, _ = dec.caller_thresholds(4)
    bg = np.linspace(10, 50, n_bits).astype(np.float32)
    norm = np.linspace(100, 400, n_bits).astype(np.float32)
    vol = np.zeros((n_bits, 1, 4, 4), np.float32)
    vol[:, 0, 1, 2] = bg + norm * cb[3]
    decoded, *_ = dec.decode_volume(
        vol, cb, bg, norm, magnitude_threshold=(1.5, 10.0),
        distance_threshold=pix_thr,
    )
    assert decoded[0, 1, 2] == 3


def test_label_connected_3d():
    decoded = np.full((3, 8, 8), -1, np.int16)
    decoded[0:2, 1:3, 1:3] = 5  # one 3D component of codeword 5
    decoded[2, 6, 6] = 5  # separate component, same codeword
    decoded[0, 5:7, 1:3] = 7  # different codeword adjacent
    labels = np.asarray(cc_ops.label_connected(jnp.asarray(decoded)))
    assert labels[decoded == -1].max() == -1
    l1 = labels[0, 1, 1]
    assert np.all(labels[0:2, 1:3, 1:3] == l1)
    assert labels[2, 6, 6] != l1
    l7 = labels[0, 5, 1]
    assert np.all(labels[0, 5:7, 1:3] == l7)
    assert l7 != l1


def test_label_connected_matches_scipy_per_codeword():
    rng = np.random.default_rng(0)
    decoded = np.full((6, 24, 24), -1, np.int16)
    # random blobs of a few codewords
    for g in range(4):
        m = rng.random((6, 24, 24)) > 0.85
        decoded[m] = g
    labels = np.asarray(cc_ops.label_connected(jnp.asarray(decoded)))
    structure = np.ones((3, 3, 3), bool)
    total_expected = 0
    for g in range(4):
        mask = decoded == g
        lab, n = scipy.ndimage.label(mask, structure=structure)
        total_expected += n
        # within each scipy component, our labels must be constant
        for comp in range(1, n + 1):
            vals = np.unique(labels[lab == comp])
            assert len(vals) == 1
    assert len(np.unique(labels[labels >= 0])) == total_expected


def test_component_stats():
    decoded = np.full((3, 8, 8), -1, np.int16)
    decoded[1, 2:4, 2:4] = 2  # 4-voxel plane component of codeword 2
    labels = cc_ops.label_connected(jnp.asarray(decoded))
    distance = np.full(decoded.shape, 0.5, np.float32)
    distance[1, 2, 2] = 0.1
    magnitude = np.full(decoded.shape, 2.0, np.float32)
    scaled = np.zeros((4, *decoded.shape), np.float32)
    scaled[1][decoded == 2] = 0.8
    stats = cc_ops.component_stats(
        jnp.asarray(decoded), labels, jnp.asarray(distance),
        jnp.asarray(magnitude), jnp.asarray(scaled), capacity=16,
    )
    valid = np.asarray(stats["valid"])
    assert valid.sum() == 1
    i = np.argmax(valid)
    assert np.asarray(stats["area"])[i] == 4
    np.testing.assert_allclose(np.asarray(stats["centroid_zyx"])[i], [1.0, 2.5, 2.5])
    assert np.asarray(stats["codeword"])[i] == 2
    np.testing.assert_allclose(np.asarray(stats["distance_min"])[i], 0.1, rtol=1e-5)
    np.testing.assert_allclose(np.asarray(stats["magnitude_mean"])[i], 2.0)
    np.testing.assert_allclose(np.asarray(stats["bit_means"])[1, i], 0.8, rtol=1e-5)
    eig = cc_ops.inertia_tensor_eigvals(
        np.asarray(stats["moments"])[i : i + 1], np.asarray(stats["area"])[i : i + 1]
    )
    assert eig.shape == (1, 3)
    assert np.all(eig[0][:-1] >= eig[0][1:])  # descending


def test_gaussian_lowpass_matches_scipy():
    rng = np.random.default_rng(2)
    vol = rng.random((6, 24, 24)).astype(np.float32)
    out = np.asarray(gaussian_lowpass(jnp.asarray(vol), sigma=(3.0, 1.0, 1.0)))
    exp = scipy.ndimage.gaussian_filter(vol, (3.0, 1.0, 1.0), mode="reflect")
    np.testing.assert_allclose(out, exp, rtol=1e-3, atol=1e-4)


def test_gaussian_lowpass_2d_mode():
    rng = np.random.default_rng(2)
    vol = rng.random((4, 16, 16)).astype(np.float32)
    out = np.asarray(gaussian_lowpass(jnp.asarray(vol), sigma=(0.0, 1.0, 1.0)))
    exp = np.stack(
        [scipy.ndimage.gaussian_filter(p, 1.0, mode="reflect") for p in vol]
    )
    np.testing.assert_allclose(out, exp, rtol=1e-3, atol=1e-4)


def test_replace_hot_pixels():
    noise = np.zeros((8, 8), np.float32)
    noise[3, 3] = 1000.0
    imgs = np.full((2, 8, 8), 100, np.uint16)
    imgs[:, 3, 3] = 60000
    out = replace_hot_pixels(noise, imgs)
    assert out[0, 3, 3] == 100
    assert out[0, 2, 2] == 100


def test_downsample_anisotropic():
    img = np.arange(4 * 6 * 6, dtype=np.float32).reshape(4, 6, 6)
    out = downsample_image_anisotropic(img, (2, 3, 3))
    assert out.shape == (2, 2, 2)
    np.testing.assert_allclose(out[0, 0, 0], img[:2, :3, :3].mean())


# -- decode and lowpass+decode against a float64 numpy oracle
def _np_decode(vol, cb, bg, norm, mag_thr, dist_thr):
    """Nearest codeword in float64: (labels, top-2 similarity gap)."""
    bits = vol.shape[0]
    t = vol.reshape(bits, -1).astype(np.float64)
    scaled = np.clip((t - bg[:, None]) / norm[:, None], 0.0, 1.0)
    mag = np.sqrt((scaled**2).sum(0))
    unit = scaled / np.maximum(mag, 1e-12)
    cbn = cb / np.linalg.norm(cb, axis=1, keepdims=True)
    sims = cbn.astype(np.float64) @ unit
    order = np.sort(sims, axis=0)
    gap = order[-1] - order[-2]
    dist = np.sqrt(np.maximum(2 - 2 * order[-1], 0))
    ok = (dist <= dist_thr) & (mag >= mag_thr[0]) & (mag <= mag_thr[1])
    labels = np.where(ok, sims.argmax(0), -1).reshape(vol.shape[1:])
    return labels, gap.reshape(vol.shape[1:]), scaled.reshape(vol.shape)


def _spotty_volume(cb, shape, seed):
    rng = np.random.default_rng(seed)
    bits = cb.shape[1]
    vol = rng.gamma(2.0, 20.0, (bits, *shape)).astype(np.float32)
    for _ in range(40):
        g = rng.integers(0, len(cb))
        z, y, x = (rng.integers(0, n) for n in shape)
        vol[:, z, y, x] += cb[g] * rng.uniform(300, 900)
    return vol


def _assert_labels_match(got, labels, gap):
    decided = gap > 1e-5
    np.testing.assert_array_equal(got[decided], labels[decided])
    assert decided.mean() > 0.5


@pytest.mark.parametrize("shape", [(3, 37, 40), (5, 64, 33), (2, 129, 17)])
def test_decode_matches_numpy_oracle(shape):
    """Ragged y and x extents decode like the float64 oracle wherever the
    nearest codeword is decided (top-2 gap > 1e-5)."""
    cb = _mhd4_codebook()
    bits = cb.shape[1]
    vol = _spotty_volume(cb, shape, seed=sum(shape))
    bg = np.full(bits, 30.0, np.float32)
    norm = np.full(bits, 500.0, np.float32)
    pix_thr, _ = dec.caller_thresholds(4)
    decoded, mag, dist, scaled = dec.decode_volume(
        vol, cb, bg, norm, magnitude_threshold=(0.3, 10.0),
        distance_threshold=pix_thr,
    )
    labels, gap, scaled_ref = _np_decode(vol, cb, bg, norm, (0.3, 10.0), pix_thr)
    _assert_labels_match(decoded, labels, gap)
    assert (labels >= 0).sum() > 0
    np.testing.assert_allclose(scaled, scaled_ref, atol=1e-3)


@pytest.mark.parametrize("z_chunk", [1, 3, 8])
def test_lowpass_decode_matches_scipy_oracle(z_chunk):
    """Lowpass + decode, streamed in z-chunks that do and do not divide
    the depth, against scipy's gaussian_filter and the float64 oracle."""
    cb = _mhd4_codebook()
    bits = cb.shape[1]
    vol = _spotty_volume(cb, (7, 40, 36), seed=11)
    bg = np.full(bits, 20.0, np.float32)
    norm = np.full(bits, 60.0, np.float32)
    sigma = (3.0, 1.0, 1.0)
    lp = np.asarray(gaussian_lowpass(jnp.asarray(vol), sigma=sigma))
    lp_ref = np.stack(
        [scipy.ndimage.gaussian_filter(v.astype(np.float64), sigma, mode="reflect")
         for v in vol]
    )
    np.testing.assert_allclose(lp, lp_ref, rtol=1e-4, atol=1e-3)
    pix_thr, _ = dec.caller_thresholds(4)
    decoded, *_ = dec.decode_volume(
        jnp.asarray(lp), cb, bg, norm, magnitude_threshold=(0.3, 10.0),
        distance_threshold=pix_thr, z_chunk=z_chunk, return_scaled=False,
    )
    labels, gap, _ = _np_decode(lp_ref, cb, bg, norm, (0.3, 10.0), pix_thr)
    _assert_labels_match(decoded, labels, gap)
    assert (labels >= 0).sum() > 0


def test_sparse_intensity_gather_matches_dense():
    """The decoder's foreground-only device gather returns exactly the
    dense lowpassed intensities at the decoded voxels."""
    from merfish3d_tpu.pipeline.decoder import _sparse_intensity_from_device

    rng = np.random.default_rng(4)
    lp = rng.random((5, 3, 20, 24)).astype(np.float32)
    decoded = np.full((3, 20, 24), -1, np.int16)
    fg = rng.choice(decoded.size, 37, replace=False)
    decoded.ravel()[fg] = rng.integers(0, 9, fg.size)
    sparse = _sparse_intensity_from_device(jnp.asarray(lp), decoded)
    lin = np.sort(fg)
    np.testing.assert_array_equal(sparse(lin), lp.reshape(5, -1)[:, lin])
    np.testing.assert_array_equal(sparse(lin[::3]), lp.reshape(5, -1)[:, lin[::3]])
    empty = _sparse_intensity_from_device(
        jnp.asarray(lp), np.full((3, 20, 24), -1, np.int16)
    )
    assert empty(np.zeros(0, np.int64)).shape == (5, 0)


def test_component_stats_overflow_does_not_corrupt_survivors():
    """With more unique labels than capacity, dropped labels must NOT be
    absorbed into surviving components' slots (review r3: searchsorted
    mapped them to neighbors' indices, silently corrupting stats)."""
    import jax.numpy as jnp

    from merfish3d_tpu.ops.cc import component_stats

    decoded = np.full((1, 8, 40), -1, np.int16)
    labels = np.full((1, 8, 40), -1, np.int32)
    for i in range(40):
        decoded[0, 2:5, i] = i % 7
        labels[0, 2:5, i] = i  # 40 single-column components, area 3 each
    stats = component_stats(
        jnp.asarray(decoded),
        jnp.asarray(labels),
        jnp.ones((1, 8, 40), jnp.float32),
        jnp.ones((1, 8, 40), jnp.float32),
        jnp.ones((2, 1, 8, 40), jnp.float32),
        capacity=16,
    )
    valid = np.asarray(stats["valid"])
    area = np.asarray(stats["area"])
    assert set(np.unique(area[valid])) == {3.0}
