"""audio.datasets for the port (counterpart of
`paddle_tpu/audio/datasets.py`): TESS and ESC-50 from a local copy only
(`archive={"path": ...}` or `data_dir=`); without one they raise with the
layout they expect. Items load through `backends.load` and an optional
feature Layer.
"""
import os

import numpy as np

from ..io import Dataset
from . import backends as _bk
from .features import MFCC, LogMelSpectrogram, MelSpectrogram, Spectrogram

__all__ = ["TESS", "ESC50", "AudioClassificationDataset"]

_FEATS = {"raw": None, "spectrogram": Spectrogram,
          "melspectrogram": MelSpectrogram,
          "logmelspectrogram": LogMelSpectrogram, "mfcc": MFCC}


class AudioClassificationDataset(Dataset):
    """reference: audio/datasets/dataset.py — (wav file, label) list with
    an optional on-the-fly feature transform."""

    def __init__(self, files, labels, feat_type="raw", sample_rate=None,
                 **kwargs):
        if feat_type not in _FEATS:
            raise ValueError(f"feat_type {feat_type!r} not in "
                             f"{sorted(_FEATS)}")
        self.files = list(files)
        self.labels = list(labels)
        self.feat_type = feat_type
        self.sample_rate = sample_rate
        self.feat_cls = _FEATS[feat_type]
        self._feat_kwargs = kwargs
        self._feat_cache = {}      # sr -> extractor (filterbank/DCT reuse)

    def __len__(self):
        return len(self.files)

    def __getitem__(self, idx):
        wav, sr = _bk.load(self.files[idx])
        if self.feat_cls is None:
            return wav, self.labels[idx]
        extractor = self._feat_cache.get(sr)
        if extractor is None:
            kw = dict(self._feat_kwargs)
            if self.feat_cls is not Spectrogram:  # Spectrogram is sr-free
                kw.setdefault("sr", sr)
            extractor = self._feat_cache[sr] = self.feat_cls(**kw)
        return extractor(wav), self.labels[idx]


class TESS(AudioClassificationDataset):
    """Toronto Emotional Speech Set (reference: datasets/tess.py).
    Layout: <data_dir>/**/<anything>_<word>_<emotion>.wav."""

    emotions = ["angry", "disgust", "fear", "happy", "neutral", "ps", "sad"]

    def __init__(self, mode="train", feat_type="raw", archive=None,
                 data_dir=None, n_folds=5, split=1, **kwargs):
        root = data_dir or (archive or {}).get("path")
        if root is None or not os.path.isdir(root):
            raise RuntimeError(
                "TESS needs a local copy (zero-egress build): pass "
                "data_dir=<folder containing the extracted TESS wavs "
                "named *_<emotion>.wav> (reference downloads from "
                "bcebos.com, datasets/tess.py archive)")
        files, labels = [], []
        for dirpath, _, names in sorted(os.walk(root)):
            for nm in sorted(names):
                if not nm.lower().endswith(".wav"):
                    continue
                emo = nm.rsplit(".", 1)[0].rsplit("_", 1)[-1].lower()
                if emo in self.emotions:
                    files.append(os.path.join(dirpath, nm))
                    labels.append(self.emotions.index(emo))
        # fold split like the reference: every n_folds-th item is dev
        keep_f, keep_l = [], []
        for i, (f, l) in enumerate(zip(files, labels)):
            fold = i % n_folds + 1
            if (mode == "train") == (fold != split):
                keep_f.append(f)
                keep_l.append(l)
        super().__init__(keep_f, keep_l, feat_type, **kwargs)


class ESC50(AudioClassificationDataset):
    """ESC-50 environmental sounds (reference: datasets/esc50.py).
    Layout: <data_dir>/audio/<fold>-*.wav + meta/esc50.csv."""

    def __init__(self, mode="train", split=1, feat_type="raw", archive=None,
                 data_dir=None, **kwargs):
        root = data_dir or (archive or {}).get("path")
        meta = os.path.join(root or "", "meta", "esc50.csv")
        if root is None or not os.path.isfile(meta):
            raise RuntimeError(
                "ESC50 needs a local copy (zero-egress build): pass "
                "data_dir=<ESC-50 root with audio/ and meta/esc50.csv> "
                "(reference downloads from github, datasets/esc50.py)")
        files, labels = [], []
        with open(meta) as f:
            header = f.readline().strip().split(",")
            fi = header.index("filename")
            ti = header.index("target")
            fo = header.index("fold")
            for line in f:
                row = line.strip().split(",")
                fold = int(row[fo])
                if (mode == "train") == (fold != split):
                    files.append(os.path.join(root, "audio", row[fi]))
                    labels.append(int(row[ti]))
        super().__init__(files, labels, feat_type, **kwargs)
