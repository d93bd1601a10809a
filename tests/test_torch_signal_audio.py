"""The port's `fft`, `signal` and `audio` against the JAX package, on the
CPU.

The same seeded numpy inputs go through `paddle_tpu.{fft,signal,audio}`
and `paddle_tpu_torch.{fft,signal,audio}`. The transforms are
`torch.fft` against `jnp.fft` (pocketfft against XLA's FFT): complex and
real outputs agree to 1e-5 of the largest magnitude; the host-side
Hermitian n-d family (scipy in both) and the host matrices (windows,
filterbanks, DCT) agree to 1e-6. The reference's own oracles
(`tests/test_signal_audio.py`: torch.stft / torch.istft parity, the
frame / overlap-add inverse, the rfftn round trip) run here on the port.
The WAV backend and the TESS / ESC-50 datasets read small files written
under `tmp_path`; nothing is downloaded.
"""
import wave

import numpy as np
import pytest
import torch

import paddle_tpu as pj

SR, T, N_FFT, HOP = 16000, 4000, 512, 128
REL = 1e-5


@pytest.fixture
def pt():
    import paddle_tpu_torch as pt
    pt.set_device("cpu")
    yield pt


def _sig():
    t = np.arange(T) / SR
    return (np.sin(2 * np.pi * 440 * t)
            + 0.5 * np.sin(2 * np.pi * 880 * t)).astype("float32")


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype.kind == want.dtype.kind
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rel * scale, \
        float(np.abs(got - want).max()) / scale


# ------------------------------------------------------------------- fft
_C = np.random.RandomState(0)
X3 = (_C.rand(4, 6, 8) + 1j * _C.rand(4, 6, 8)).astype(np.complex64)
R3 = _C.rand(4, 6, 8).astype(np.float32)

FFT_CASES = [
    ("fft", X3, dict(n=10, axis=1)), ("ifft", X3, dict(norm="ortho")),
    ("fft2", X3, dict(s=(5, 4))), ("ifft2", X3, dict(norm="forward")),
    ("fftn", X3, dict(axes=(0, 2))), ("ifftn", X3, {}),
    ("rfft", R3, dict(n=12, norm="ortho")), ("irfft", X3, dict(n=14)),
    ("rfft2", R3, {}), ("irfft2", X3, dict(s=(6, 14))),
    ("rfftn", R3, dict(norm="forward")), ("irfftn", X3, dict(s=(4, 6, 8))),
    ("hfft", X3, dict(n=14)), ("ihfft", R3, dict(norm="ortho")),
    ("fftshift", R3, dict(axes=(1,))), ("ifftshift", X3, {}),
    ("hfft2", X3, {}), ("ihfft2", R3, dict(norm="ortho")),
    ("hfftn", X3, dict(axes=(0, 2))), ("ihfftn", R3, {}),
]


@pytest.mark.parametrize("name,x,kw", FFT_CASES, ids=[c[0] for c in
                                                       FFT_CASES])
def test_fft_matches_jax(pt, name, x, kw):
    want = getattr(pj.fft, name)(pj.to_tensor(x), **kw).numpy()
    got = getattr(pt.fft, name)(pt.to_tensor(x), **kw).numpy()
    _close(got, want, 1e-6 if name.startswith(("hfft2", "ihfft2", "hfftn",
                                               "ihfftn")) else REL)


def test_fft_frequencies_and_norm_names(pt):
    np.testing.assert_allclose(pt.fft.fftfreq(8, 0.5).numpy(),
                               pj.fft.fftfreq(8, 0.5).numpy(), rtol=1e-7)
    np.testing.assert_allclose(pt.fft.rfftfreq(9).numpy(),
                               pj.fft.rfftfreq(9).numpy(), rtol=1e-7)
    with pytest.raises(KeyError):
        pt.fft.fft(pt.to_tensor(R3), norm="unitary")


def test_fft_gradient_matches_jax(pt):
    x = _C.rand(3, 16).astype(np.float32)
    w = _C.rand(3, 9).astype(np.float32)
    xs = []
    for P in (pj, pt):
        t = P.to_tensor(x, stop_gradient=False)
        y = P.fft.rfft(t, norm="ortho")
        (y.abs() * P.to_tensor(w)).sum().backward()
        xs.append(t.grad.numpy())
    _close(xs[1], xs[0])


def test_rfftn_roundtrip(pt):
    x = np.random.RandomState(0).rand(4, 6, 8).astype("float32")
    X = pt.fft.rfftn(pt.to_tensor(x))
    back = pt.fft.irfftn(X, s=(4, 6, 8))
    np.testing.assert_allclose(back.numpy(), x, atol=1e-5)


# ---------------------------------------------------------------- signal
def test_stft_matches_torch(pt):
    x = _sig()
    win = pt.audio.functional.get_window("hann", N_FFT)
    spec = pt.signal.stft(pt.to_tensor(x[None]), N_FFT, HOP, window=win)
    ref = torch.stft(torch.tensor(x[None]), N_FFT, HOP,
                     window=torch.hann_window(N_FFT, periodic=True),
                     center=True, pad_mode="reflect",
                     return_complex=True).numpy()
    ours = spec.numpy()
    assert ours.shape == ref.shape
    assert np.abs(ours - ref).max() / np.abs(ref).max() < 1e-5


def test_istft_roundtrip_and_torch_parity(pt):
    x = _sig()
    win = pt.audio.functional.get_window("hann", N_FFT)
    spec = pt.signal.stft(pt.to_tensor(x[None]), N_FFT, HOP, window=win)
    rec = pt.signal.istft(spec, N_FFT, HOP, window=win, length=T).numpy()[0]
    ref = torch.istft(torch.tensor(spec.numpy()), N_FFT, HOP,
                      window=torch.hann_window(N_FFT), length=T).numpy()[0]
    assert np.abs(rec - ref).max() < 1e-4
    assert np.abs(rec[:3900] - x[:3900]).max() < 1e-4


STFT_CASES = {
    "default": dict(),
    "no_center": dict(center=False),
    "constant_pad": dict(pad_mode="constant"),
    "normalized": dict(normalized=True),
    "twosided": dict(onesided=False),
    "short_window": dict(win_length=200, window="hamming"),
}


@pytest.mark.parametrize("case", list(STFT_CASES))
def test_stft_istft_options_match_jax(pt, case):
    kw = dict(STFT_CASES[case])
    x = np.random.RandomState(1).randn(2, 2000).astype(np.float32)
    outs = []
    for P in (pj, pt):
        k = dict(kw)
        if "window" in k:
            k["window"] = P.audio.functional.get_window(k["window"],
                                                        k["win_length"])
        spec = P.signal.stft(P.to_tensor(x), 256, 64, **k)
        k.pop("pad_mode", None)
        back = P.signal.istft(spec, 256, 64, length=2000, **k)
        outs.append((spec.numpy(), back.numpy()))
    _close(outs[1][0], outs[0][0])
    _close(outs[1][1], outs[0][1], 1e-4)


def test_stft_one_dimensional_and_gradient(pt):
    x = np.random.RandomState(2).randn(1024).astype(np.float32)
    grads = []
    for P in (pj, pt):
        t = P.to_tensor(x, stop_gradient=False)
        spec = P.signal.stft(t, 128, 32)
        assert tuple(spec.shape) == (65, 33)
        spec.abs().sum().backward()
        grads.append(t.grad.numpy())
    _close(grads[1], grads[0], 1e-4)


def test_frame_overlap_add_inverse(pt):
    x = np.arange(32, dtype="float32")
    fr = pt.signal.frame(pt.to_tensor(x), 8, 8)
    assert list(fr.shape) == [8, 4]
    np.testing.assert_allclose(fr.numpy()[:, 0], np.arange(8,
                                                           dtype="float32"))
    np.testing.assert_allclose(pt.signal.overlap_add(fr, 8).numpy(), x)
    fr0 = pt.signal.frame(pt.to_tensor(x), 8, 8, axis=0)
    assert list(fr0.shape) == [4, 8]
    np.testing.assert_allclose(pt.signal.overlap_add(fr0, 8, axis=0).numpy(),
                               x)


@pytest.mark.parametrize("axis", [-1, 0])
def test_frame_overlap_add_match_jax(pt, axis):
    x = np.random.RandomState(3).randn(3, 40).astype(np.float32)
    if axis == 0:
        x = np.ascontiguousarray(x.T)
    outs = []
    for P in (pj, pt):
        fr = P.signal.frame(P.to_tensor(x), 10, 4, axis=axis)
        outs.append((fr.numpy(), P.signal.overlap_add(fr, 4,
                                                      axis=axis).numpy()))
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_allclose(outs[1][1], outs[0][1], rtol=1e-6, atol=1e-6)


# ----------------------------------------------------------------- audio
@pytest.mark.parametrize("window", ["hann", "hamming", "blackman", "boxcar",
                                    ("gaussian", 3.0)])
@pytest.mark.parametrize("fftbins", [True, False])
def test_windows_match_jax(pt, window, fftbins):
    np.testing.assert_allclose(
        pt.audio.functional.get_window(window, 64, fftbins).numpy(),
        pj.audio.functional.get_window(window, 64, fftbins).numpy(),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("htk", [False, True])
def test_mel_scale_fbank_dct_match_jax(pt, htk):
    F_, J_ = pt.audio.functional, pj.audio.functional
    for f in (440.0, 1000.0, 3000.0, np.array([0.0, 900.0, 4000.0])):
        np.testing.assert_allclose(F_.hz_to_mel(f, htk), J_.hz_to_mel(f, htk))
        np.testing.assert_allclose(F_.mel_to_hz(F_.hz_to_mel(f, htk), htk),
                                   J_.mel_to_hz(J_.hz_to_mel(f, htk), htk))
    for norm in ("slaney", None):
        np.testing.assert_allclose(
            F_.compute_fbank_matrix(SR, N_FFT, 40, 50.0, None, htk,
                                    norm).numpy(),
            J_.compute_fbank_matrix(SR, N_FFT, 40, 50.0, None, htk,
                                    norm).numpy(), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(F_.create_dct(13, 40).numpy(),
                               J_.create_dct(13, 40).numpy(), rtol=1e-6,
                               atol=1e-7)


def test_window_and_fbank_shapes(pt):
    w = pt.audio.functional.get_window("hamming", 128)
    assert list(w.shape) == [128]
    fb = pt.audio.functional.compute_fbank_matrix(SR, N_FFT, n_mels=40)
    assert list(fb.shape) == [40, N_FFT // 2 + 1]
    fbn = fb.numpy()
    assert (fbn >= 0).all() and (fbn.sum(1) > 0).mean() > 0.9
    assert list(pt.audio.functional.create_dct(13, 40).shape) == [40, 13]


@pytest.mark.parametrize("top_db", [None, 80.0])
def test_power_to_db_matches_jax(pt, top_db):
    s = (np.random.RandomState(4).rand(3, 20) ** 6).astype(np.float32)
    np.testing.assert_allclose(
        pt.audio.functional.power_to_db(pt.to_tensor(s), 2.0, 1e-8,
                                        top_db).numpy(),
        pj.audio.functional.power_to_db(pj.to_tensor(s), 2.0, 1e-8,
                                        top_db).numpy(), rtol=1e-5,
        atol=1e-4)


FEATURES = {
    "Spectrogram": dict(n_fft=N_FFT, hop_length=HOP),
    "MelSpectrogram": dict(sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=40),
    "LogMelSpectrogram": dict(sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=40,
                              top_db=80.0),
    "MFCC": dict(sr=SR, n_mfcc=13, n_fft=N_FFT, hop_length=HOP, n_mels=40),
}


@pytest.mark.parametrize("name", list(FEATURES))
def test_feature_layers_match_jax(pt, name):
    """Outputs (of the largest magnitude: 1e-5 linear, 1e-4 in dB) and the
    input gradient under a seeded cotangent, over noise: every mel bin
    holds energy far above `amin`, where the log's gradient is
    well-conditioned (a pure tone leaves bins near 1e-14, whose gradients
    differ between any two FFTs)."""
    x = np.random.RandomState(5).randn(2, T).astype(np.float32)
    outs = []
    for P in (pj, pt):
        layer = getattr(P.audio, name)(**FEATURES[name])
        t = P.to_tensor(x, stop_gradient=False)
        y = layer(t)
        w = np.random.RandomState(6).rand(*y.shape).astype(np.float32)
        (y * P.to_tensor(w)).sum().backward()
        outs.append((y.numpy(), t.grad.numpy()))
    rel = 1e-4 if name in ("LogMelSpectrogram", "MFCC") else REL
    _close(outs[1][0], outs[0][0], rel)
    _close(outs[1][1], outs[0][1], 1e-4)


def test_mel_mfcc_features(pt):
    x = _sig()
    mel = pt.audio.features.MelSpectrogram(sr=SR, n_fft=N_FFT,
                                           hop_length=HOP, n_mels=40)
    m = mel(pt.to_tensor(x[None]))
    assert list(m.shape)[:2] == [1, 40]
    assert 1 <= int(np.argmax(m.numpy()[0].mean(-1))) <= 15
    lm = pt.audio.features.LogMelSpectrogram(
        sr=SR, n_fft=N_FFT, hop_length=HOP, n_mels=40, top_db=80.0)
    out = lm(pt.to_tensor(x[None])).numpy()
    assert np.isfinite(out).all() and out.max() - out.min() <= 80.0 + 1e-3


def test_feature_buffers_follow_the_layer(pt):
    """The window, filterbank and DCT are non-persistable buffers: left
    out of state_dict, listed among the buffers, moved by `to`."""
    mfcc = pt.audio.MFCC(sr=SR, n_mfcc=13, n_fft=N_FFT, n_mels=40)
    assert mfcc.state_dict() == {} or len(mfcc.state_dict()) == 0
    names = {n for n, _ in mfcc.named_buffers()}
    assert {"dct", "logmel.mel.fbank",
            "logmel.mel.spectrogram.window"} <= names


# --------------------------------------------------------------- backends
def _write_wav(path, data, sr, width=2):
    with wave.open(str(path), "wb") as f:
        f.setnchannels(data.shape[0])
        f.setsampwidth(width)
        f.setframerate(sr)
        f.writeframes(np.ascontiguousarray(data.T).tobytes())


def test_wave_backend_matches_jax(pt, tmp_path):
    rng = np.random.RandomState(7)
    pcm = rng.randint(-2 ** 15, 2 ** 15, (2, 1000)).astype(np.int16)
    path = tmp_path / "a.wav"
    _write_wav(path, pcm, 8000)
    for kw in (dict(), dict(normalize=False), dict(frame_offset=100,
                                                   num_frames=300),
               dict(channels_first=False)):
        a, sr_a = pt.audio.load(path, **kw)
        b, sr_b = pj.audio.load(path, **kw)
        assert sr_a == sr_b == 8000
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    ia, ib = pt.audio.info(path), pj.audio.info(path)
    assert vars(ia) == vars(ib)
    x = rng.uniform(-1, 1, (1, 500)).astype(np.float32)
    pt.audio.save(tmp_path / "p.wav", pt.to_tensor(x), 16000)
    pj.audio.save(tmp_path / "j.wav", pj.to_tensor(x), 16000)
    assert (tmp_path / "p.wav").read_bytes() == \
        (tmp_path / "j.wav").read_bytes()
    assert pt.audio.backends.list_available_backends() == ["wave_backend"]
    with pytest.raises(NotImplementedError):
        pt.audio.backends.set_backend("soundfile")


# --------------------------------------------------------------- datasets
def _tess(root, rng):
    for i, emo in enumerate(["angry", "happy", "sad", "neutral", "ps", "fear",
                             "disgust", "happy", "sad", "angry"]):
        d = root / f"spk{i % 2}"
        d.mkdir(exist_ok=True)
        _write_wav(d / f"OAF_word{i}_{emo}.wav",
                   rng.randint(-3000, 3000, (1, 800)).astype(np.int16), 8000)


def _esc50(root, rng):
    (root / "audio").mkdir()
    (root / "meta").mkdir()
    rows = ["filename,fold,target,category,esc10,src_file,take"]
    for i in range(8):
        name = f"{i % 5 + 1}-{100 + i}-A-{i % 3}.wav"
        _write_wav(root / "audio" / name,
                   rng.randint(-3000, 3000, (1, 600)).astype(np.int16), 8000)
        rows.append(f"{name},{i % 5 + 1},{i % 3},c{i % 3},False,{100 + i},A")
    (root / "meta" / "esc50.csv").write_text("\n".join(rows) + "\n")


@pytest.mark.parametrize("which", ["TESS", "ESC50"])
@pytest.mark.parametrize("mode", ["train", "dev"])
def test_audio_datasets_match_jax(pt, tmp_path, which, mode):
    rng = np.random.RandomState(8)
    (_tess if which == "TESS" else _esc50)(tmp_path, rng)
    kw = dict(mode=mode, data_dir=str(tmp_path))
    for feat, extra in (("raw", {}), ("mfcc", dict(n_mfcc=8, n_fft=128,
                                                   n_mels=16))):
        a = getattr(pt.audio.datasets, which)(feat_type=feat, **kw, **extra)
        b = getattr(pj.audio.datasets, which)(feat_type=feat, **kw, **extra)
        assert len(a) == len(b) > 0
        assert a.labels == b.labels
        for i in range(len(a)):
            xa, la = a[i]
            xb, lb = b[i]
            assert la == lb
            _close(xa.numpy(), xb.numpy(), 1e-4)


def test_audio_datasets_need_a_local_copy(pt, tmp_path):
    for cls in (pt.audio.datasets.TESS, pt.audio.datasets.ESC50):
        with pytest.raises(RuntimeError, match="local copy"):
            cls()
    with pytest.raises(RuntimeError, match="local copy"):
        pt.audio.datasets.ESC50(archive={"path": str(tmp_path)})
