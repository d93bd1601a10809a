"""The reference's text datasets (counterpart of
`paddle_tpu/text/datasets_ref.py`).

Nothing is downloaded: every dataset takes `data_file` pointing at the
archive format the reference downloads (aclImdb tar, PTB simple-examples
tar, movielens zip, UCI housing whitespace floats, CoNLL tgz, WMT tars)
and raises without one. The parsing is the reference's, so an existing
cached archive works unchanged. Numpy and the standard library only.
"""
import re
import tarfile
import zipfile

import numpy as np

from ..io import Dataset

__all__ = ["Conll05st", "Imdb", "Imikolov", "Movielens", "UCIHousing",
           "WMT14", "WMT16"]


def _need(data_file, name, what):
    if data_file is None:
        raise RuntimeError(
            f"{name}: zero-egress build cannot download; pass data_file="
            f"<{what}> (the reference's cached archive works unchanged)")
    return data_file


class UCIHousing(Dataset):
    """reference: uci_housing.py — 13 features + price, whitespace floats,
    80/20 train/test split, feature-wise min/max/avg normalization."""

    def __init__(self, data_file=None, mode="train", download=True):
        data_file = _need(data_file, "UCIHousing",
                          "housing.data (whitespace floats)")
        data = np.fromfile(data_file, sep=" ")
        feature_num = 14
        data = data.reshape(data.shape[0] // feature_num, feature_num)
        mx, mn, avg = data.max(0), data.min(0), data.sum(0) / data.shape[0]
        for i in range(feature_num - 1):
            data[:, i] = (data[:, i] - avg[i]) / (mx[i] - mn[i])
        offset = int(data.shape[0] * 0.8)
        self.data = data[:offset] if mode == "train" else data[offset:]

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        row = self.data[idx].astype("float32")
        return row[:-1], row[-1:]


class Imdb(Dataset):
    """reference: imdb.py — aclImdb tar; builds the word dict over
    train+test docs with frequency cutoff, yields (ids, 0/1)."""

    def __init__(self, data_file=None, mode="train", cutoff=150,
                 download=True):
        self.data_file = _need(data_file, "Imdb", "aclImdb_v1.tar.gz")
        self.mode = mode
        self.word_idx = self._build_word_dict(cutoff)
        self.docs, self.labels = [], []
        pos = re.compile(rf"aclImdb/{mode}/pos/.*\.txt$")
        neg = re.compile(rf"aclImdb/{mode}/neg/.*\.txt$")
        for pat, lab in ((pos, 0), (neg, 1)):
            for toks in self._tokenize(pat):
                unk = self.word_idx["<unk>"]
                self.docs.append(np.asarray(
                    [self.word_idx.get(t, unk) for t in toks], np.int64))
                self.labels.append(lab)

    def _tokenize(self, pattern):
        out = []
        with tarfile.open(self.data_file) as tarf:
            for tf in tarf.getmembers():
                if pattern.match(tf.name or ""):
                    data = tarf.extractfile(tf).read().decode("latin-1")
                    out.append(data.lower().translate(
                        str.maketrans("", "", "!\"#$%&'()*+,-./:;<=>?@[]^_`{|}~")).split())
        return out

    def _build_word_dict(self, cutoff):
        freq = {}
        pat = re.compile(r"aclImdb/((train)|(test))/((pos)|(neg))/.*\.txt$")
        for toks in self._tokenize(pat):
            for t in toks:
                freq[t] = freq.get(t, 0) + 1
        freq.pop("<unk>", None)
        kept = sorted([(v, k) for k, v in freq.items() if v > cutoff],
                      reverse=True)
        word_idx = {k: i for i, (_, k) in enumerate(kept)}
        word_idx["<unk>"] = len(word_idx)
        return word_idx

    def __len__(self):
        return len(self.docs)

    def __getitem__(self, idx):
        return self.docs[idx], np.asarray([self.labels[idx]])


class Imikolov(Dataset):
    """reference: imikolov.py — PTB simple-examples tar; ngram or seq
    yielding over the word dict (cutoff via min word freq)."""

    def __init__(self, data_file=None, data_type="NGRAM", window_size=-1,
                 mode="train", min_word_freq=50, download=True):
        self.data_file = _need(data_file, "Imikolov",
                               "simple-examples.tgz (PTB)")
        self.type = data_type.upper()
        self.window = window_size
        self.word_idx = self._build_dict(min_word_freq)
        path = f"./simple-examples/data/ptb.{'train' if mode == 'train' else 'valid'}.txt"
        self.data = []
        with tarfile.open(self.data_file) as tf:
            f = tf.extractfile(tf.getmember(path))
            for line in f.read().decode().split("\n"):
                words = ["<s>"] + line.strip().split() + ["<e>"]
                ids = [self.word_idx.get(w, self.word_idx["<unk>"])
                       for w in words]
                if self.type == "NGRAM":
                    if self.window < 1:
                        raise ValueError("NGRAM needs window_size >= 1")
                    for i in range(self.window, len(ids)):
                        self.data.append(tuple(ids[i - self.window:i + 1]))
                else:
                    if len(ids) > 2:
                        self.data.append((np.asarray(ids[:-1], np.int64),
                                          np.asarray(ids[1:], np.int64)))

    def _build_dict(self, min_freq):
        freq = {}
        with tarfile.open(self.data_file) as tf:
            f = tf.extractfile(
                tf.getmember("./simple-examples/data/ptb.train.txt"))
            for line in f.read().decode().split("\n"):
                for w in line.strip().split():
                    freq[w] = freq.get(w, 0) + 1
        freq.pop("<unk>", None)
        kept = sorted([(v, k) for k, v in freq.items() if v >= min_freq],
                      reverse=True)
        word_idx = {k: i for i, (_, k) in enumerate(kept)}
        word_idx["<unk>"] = len(word_idx)
        word_idx.setdefault("<s>", len(word_idx))
        word_idx.setdefault("<e>", len(word_idx))
        return word_idx

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        item = self.data[idx]
        if self.type == "NGRAM":
            return tuple(np.asarray([v], np.int64) for v in item)
        return item


class Movielens(Dataset):
    """reference: movielens.py — ml-1m zip: ratings.dat user::movie::rate,
    users.dat, movies.dat; yields (user feats, movie feats, rating)."""

    def __init__(self, data_file=None, mode="train", test_ratio=0.1,
                 rand_seed=0, download=True):
        self.data_file = _need(data_file, "Movielens", "ml-1m.zip")
        rng = np.random.RandomState(rand_seed)
        movies, users = {}, {}
        with zipfile.ZipFile(self.data_file) as z:
            root = z.namelist()[0].split("/")[0]
            with z.open(f"{root}/movies.dat") as f:
                for line in f.read().decode("latin-1").strip().split("\n"):
                    mid, title, genres = line.strip().split("::")
                    movies[int(mid)] = (int(mid), title, genres.split("|"))
            with z.open(f"{root}/users.dat") as f:
                for line in f.read().decode("latin-1").strip().split("\n"):
                    uid, gender, age, job, _zip = line.strip().split("::")
                    users[int(uid)] = (int(uid), gender, int(age), int(job))
            rows = []
            with z.open(f"{root}/ratings.dat") as f:
                for line in f.read().decode("latin-1").strip().split("\n"):
                    uid, mid, rate, _ts = line.strip().split("::")
                    is_test = rng.rand() < test_ratio
                    if (mode == "test") == is_test:
                        rows.append((users[int(uid)], movies[int(mid)],
                                     float(rate)))
        self.rows = rows

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, idx):
        u, m, r = self.rows[idx]
        return u, m, np.asarray([r], np.float32)


class Conll05st(Dataset):
    """reference: conll05.py — SRL dataset (words/props tgz pair + word/
    verb/target dicts); yields the 9-slot id tuple. The official test
    archive layout is conll05st-release/test.wsj/words|props."""

    def __init__(self, data_file=None, word_dict_file=None,
                 verb_dict_file=None, target_dict_file=None, mode="test",
                 download=True):
        self.data_file = _need(data_file, "Conll05st",
                               "conll05st-tests.tar.gz")
        self.word_dict = self._load_dict(word_dict_file)
        self.verb_dict = self._load_dict(verb_dict_file)
        self.label_dict = self._load_dict(target_dict_file)
        self.samples = self._load(mode)

    def _load_dict(self, path):
        if path is None:
            return {}
        out = {}
        with open(path) as f:
            for i, line in enumerate(f):
                out[line.strip()] = i
        return out

    def _load(self, mode):
        words_lines, props_lines = [], []
        with tarfile.open(self.data_file) as tf:
            for m in tf.getmembers():
                if m.name.endswith("words.gz") or m.name.endswith("words"):
                    words_lines = self._read_member(tf, m)
                elif m.name.endswith("props.gz") or m.name.endswith("props"):
                    props_lines = self._read_member(tf, m)
        # group sentences (blank-line separated)
        sents, cur_w, cur_p = [], [], []
        for w, p in zip(words_lines, props_lines):
            if not w.strip():
                if cur_w:
                    sents.append((cur_w, cur_p))
                cur_w, cur_p = [], []
            else:
                cur_w.append(w.strip())
                cur_p.append(p.strip().split())
        if cur_w:
            sents.append((cur_w, cur_p))
        unk = len(self.word_dict)
        samples = []
        for words, props in sents:
            ids = np.asarray([self.word_dict.get(w, unk) for w in words],
                             np.int64)
            labels = np.asarray(
                [self.label_dict.get(p[-1] if p else "O", 0)
                 for p in props], np.int64)
            samples.append((ids, labels))
        return samples

    def _read_member(self, tf, member):
        import gzip
        import io
        raw = tf.extractfile(member).read()
        if member.name.endswith(".gz"):
            raw = gzip.decompress(raw)
        return io.StringIO(raw.decode("latin-1")).read().split("\n")

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]


class _WMTBase(Dataset):
    """Common WMT parsing: source/target token files inside a tar, a
    word dict per side, yields (src_ids, tgt_ids, tgt_ids_next)."""

    START, END, UNK = "<s>", "<e>", "<unk>"

    def _pair_to_ids(self, src, tgt):
        s = [self.src_dict.get(w, self.src_dict[self.UNK])
             for w in src.split()]
        t = ([self.src_dict.get(self.START, 0)]
             + [self.tgt_dict.get(w, self.tgt_dict[self.UNK])
                for w in tgt.split()])
        t_next = t[1:] + [self.tgt_dict.get(self.END, 0)]
        return (np.asarray(s, np.int64), np.asarray(t, np.int64),
                np.asarray(t_next, np.int64))

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, idx):
        return self.samples[idx]


class WMT14(_WMTBase):
    """reference: wmt14.py — dev+test tar with .src/.trg file pairs and
    bundled dictionaries (wmt14 dict format: one token per line)."""

    def __init__(self, data_file=None, mode="train", dict_size=30000,
                 download=True):
        self.data_file = _need(data_file, "WMT14", "wmt14 tar")
        self.samples = []
        src_lines, trg_lines = [], []
        with tarfile.open(self.data_file) as tf:
            names = [m.name for m in tf.getmembers()]
            for nm in sorted(names):
                low = nm.lower()
                if mode in low and low.endswith(".src"):
                    src_lines = tf.extractfile(nm).read().decode(
                        "latin-1").strip().split("\n")
                if mode in low and (low.endswith(".trg")
                                    or low.endswith(".tgt")):
                    trg_lines = tf.extractfile(nm).read().decode(
                        "latin-1").strip().split("\n")
        self.src_dict = self._build(src_lines, dict_size)
        self.tgt_dict = self._build(trg_lines, dict_size)
        for s, t in zip(src_lines, trg_lines):
            self.samples.append(self._pair_to_ids(s, t))

    def _build(self, lines, dict_size):
        freq = {}
        for line in lines:
            for w in line.split():
                freq[w] = freq.get(w, 0) + 1
        kept = sorted(freq, key=lambda k: -freq[k])[:dict_size - 3]
        d = {self.START: 0, self.END: 1, self.UNK: 2}
        for w in kept:
            d[w] = len(d)
        return d


class WMT16(_WMTBase):
    """reference: wmt16.py — mmt16 task1 tar (train/val/test .en/.de)."""

    def __init__(self, data_file=None, mode="train", src_dict_size=-1,
                 trg_dict_size=-1, lang="en", download=True):
        self.data_file = _need(data_file, "WMT16", "wmt16 tar")
        other = "de" if lang == "en" else "en"
        part = {"train": "train", "dev": "val", "val": "val",
                "test": "test"}[mode]
        src_lines, trg_lines = [], []
        with tarfile.open(self.data_file) as tf:
            for m in tf.getmembers():
                low = m.name.lower()
                if part in low and low.endswith(f".{lang}"):
                    src_lines = tf.extractfile(m).read().decode(
                        "utf-8").strip().split("\n")
                if part in low and low.endswith(f".{other}"):
                    trg_lines = tf.extractfile(m).read().decode(
                        "utf-8").strip().split("\n")
        n_src = src_dict_size if src_dict_size > 0 else 30000
        n_trg = trg_dict_size if trg_dict_size > 0 else 30000
        self.src_dict = WMT14._build(self, src_lines, n_src)
        self.tgt_dict = WMT14._build(self, trg_lines, n_trg)
        self.samples = [self._pair_to_ids(s, t)
                        for s, t in zip(src_lines, trg_lines)]
