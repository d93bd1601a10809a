"""Calibration observers for post-training quantization (the port's copy
of `paddle_tpu/quantization/observers.py`, numpy as there, so thresholds
are equal between the packages).

Reference: python/paddle/fluid/contrib/slim/quantization/
post_training_quantization.py (algo = KL / hist / mse / avg / abs_max /
min_max, histogram sampling with range growth) and cal_kl_threshold.py
(TensorRT-style KL-divergence threshold search), as vectorized numpy over
a fixed-bin histogram whose range doubles to absorb new batches.

The observers run on the host (calibration is a data pass, not a hot
loop); the scales they give feed the fake-quant ops.
"""
import numpy as np

__all__ = ["HistogramObserver", "kl_threshold", "mse_threshold",
           "hist_percentile_threshold", "channel_abs_max"]

BINS = 2048


class HistogramObserver:
    """Accumulate |x| into a fixed-bin histogram, doubling the range (and
    pairwise-merging counts) whenever a batch exceeds it. Also tracks
    per-batch abs-max (for avg) and the global min/max (for min_max)."""

    def __init__(self, bins=BINS):
        self.bins = bins
        self.hist = np.zeros(bins, np.float64)
        self.hi = 0.0                 # current histogram range [0, hi)
        self.batch_maxes = []
        self.vmin = np.inf
        self.vmax = -np.inf

    def collect(self, arr):
        a = np.asarray(arr, np.float32).reshape(-1)
        if a.size == 0:
            return
        # non-finite samples are DROPPED, not binned: a single inf would
        # otherwise spin the range-doubling loop forever (hi can never
        # catch an infinite batch max), and a NaN poisons vmin/vmax and
        # every threshold derived from them. Calibration data with
        # overflow garbage should clip it upstream; the observer's job
        # is to stay deterministic regardless.
        finite = np.isfinite(a)
        if not finite.all():
            a = a[finite]
            if a.size == 0:
                return
        self.vmin = min(self.vmin, float(a.min()))
        self.vmax = max(self.vmax, float(a.max()))
        a = np.abs(a)
        m = float(a.max())
        self.batch_maxes.append(m)
        if m == 0.0 and self.hi == 0.0:
            return                        # nothing to bin yet (all-zero batch)
        if m > self.hi:
            if self.hi == 0.0:
                self.hi = m
            while self.hi < m:
                # double the range: merge neighbouring bin pairs into the
                # lower half, zero the upper half
                merged = self.hist.reshape(-1, 2).sum(1)
                self.hist[:self.bins // 2] = merged
                self.hist[self.bins // 2:] = 0.0
                self.hi *= 2.0
        idx = np.minimum((a / self.hi * self.bins).astype(np.int64),
                         self.bins - 1)
        self.hist += np.bincount(idx, minlength=self.bins)

    @property
    def bin_width(self):
        return self.hi / self.bins if self.hi > 0 else 0.0

    def abs_max(self):
        return max(self.batch_maxes) if self.batch_maxes else 0.0

    def avg(self):
        return float(np.mean(self.batch_maxes)) if self.batch_maxes else 0.0

    def threshold(self, algo, bits=8, percent=0.9999):
        if self.hi == 0.0:
            return 0.0
        if algo == "abs_max":
            return self.abs_max()
        if algo == "min_max":
            return max(abs(self.vmin), abs(self.vmax))
        if algo == "avg":
            return self.avg()
        if algo == "hist":
            return hist_percentile_threshold(self.hist, self.bin_width,
                                             percent)
        if algo == "KL":
            return kl_threshold(self.hist, self.bin_width, bits)
        if algo == "mse":
            return mse_threshold(self.hist, self.bin_width, bits)
        raise ValueError(
            f"unknown calibration algo '{algo}' (supported: abs_max, "
            "min_max, avg, hist, KL, mse)")


def hist_percentile_threshold(hist, bin_width, percent):
    """Threshold at the `percent` quantile of the |x| histogram (reference
    algo='hist': value of 'hist_percent' quantile)."""
    c = np.cumsum(hist)
    if c[-1] == 0:
        return 0.0
    i = int(np.searchsorted(c, percent * c[-1]))
    return (i + 1) * bin_width


def _quantize_hist(ref, levels):
    """Project a clipped |x| histogram onto `levels` uniform bins and
    expand back, preserving which source bins were empty (the reference's
    expand_quantized_bins semantics, vectorized)."""
    n = ref.shape[0]
    group = np.minimum(np.arange(n) * levels // n, levels - 1)
    q = np.bincount(group, weights=ref, minlength=levels)
    nonzero = (ref > 0).astype(np.float64)
    nz_per_group = np.bincount(group, weights=nonzero, minlength=levels)
    with np.errstate(divide="ignore", invalid="ignore"):
        per_bin = np.where(nz_per_group > 0, q / nz_per_group, 0.0)
    return per_bin[group] * nonzero


def kl_threshold(hist, bin_width, bits=8):
    """TensorRT-style KL calibration: pick the clip point i whose clipped+
    quantized distribution is closest (min KL divergence) to the observed
    one (reference cal_kl_threshold.py, vectorized per-candidate)."""
    hist = np.asarray(hist, np.float64)
    n = hist.shape[0]
    levels = 2 ** (bits - 1) - 1
    total = hist.sum()
    if total == 0:
        return 0.0
    best_i, best_kl = n, np.inf
    for i in range(max(levels, n // 2), n + 1):
        ref = hist[:i].copy()
        if ref[i - 1] == 0:
            continue
        ref[i - 1] += hist[i:].sum()        # fold outliers into the edge
        q = _quantize_hist(ref, levels)
        p_mask = ref > 0
        q_safe = np.where(q > 0, q, 1e-30)
        p = ref[p_mask] / ref.sum()
        qn = q_safe[p_mask] / max(q.sum(), 1e-30)
        kl = float(np.sum(p * np.log(p / qn)))
        if kl < best_kl:
            best_kl, best_i = kl, i
    return (best_i + 0.5) * bin_width


def mse_threshold(hist, bin_width, bits=8):
    """Scale minimizing quantization MSE, evaluated on histogram centers
    (reference algo='mse': threshold search by quant-dequant loss)."""
    hist = np.asarray(hist, np.float64)
    n = hist.shape[0]
    qmax = 2 ** (bits - 1) - 1
    centers = (np.arange(n) + 0.5) * bin_width
    abs_max = n * bin_width
    best_s, best_loss = abs_max, np.inf
    for frac in np.linspace(0.1, 1.0, 91):
        s = frac * abs_max
        q = np.clip(np.round(centers / s * qmax), -qmax, qmax) * s / qmax
        loss = float(np.sum(((centers - q) ** 2) * hist))
        if loss < best_loss:
            best_loss, best_s = loss, s
    return best_s


def channel_abs_max(w, axis):
    """Per-channel |w| max along every dim except `axis` (reference
    fake_channel_wise_quantize_abs_max: one scale per output channel)."""
    w = np.asarray(w)
    reduce_axes = tuple(i for i in range(w.ndim) if i != axis)
    return np.abs(w).max(axis=reduce_axes)
