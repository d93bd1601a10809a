"""Synthetic text datasets (counterpart of `paddle_tpu/text/datasets.py`):
seeded random token sequences and a language-model view of a token
array; numpy only, so loader workers can run them."""
import numpy as np

from ..io import Dataset


class FakeTextDataset(Dataset):
    """Random token sequences for LM smoke training."""

    def __init__(self, num_samples=1024, seq_len=128, vocab_size=50304, seed=0):
        self.num_samples = num_samples
        self.seq_len = seq_len
        self.vocab_size = vocab_size
        self.seed = seed

    def __getitem__(self, idx):
        rng = np.random.RandomState(self.seed + idx)
        tokens = rng.randint(0, self.vocab_size, self.seq_len + 1, dtype=np.int64)
        return tokens[:-1], tokens[1:]

    def __len__(self):
        return self.num_samples


class LMDataset(Dataset):
    """Language-model dataset over a token array (e.g. np.memmap)."""

    def __init__(self, tokens, seq_len=1024):
        self.tokens = tokens
        self.seq_len = seq_len

    def __getitem__(self, idx):
        s = idx * self.seq_len
        chunk = np.asarray(self.tokens[s:s + self.seq_len + 1], dtype=np.int64)
        return chunk[:-1], chunk[1:]

    def __len__(self):
        return (len(self.tokens) - 1) // self.seq_len
