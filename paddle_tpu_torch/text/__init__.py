"""paddle.text for the port (counterpart of `paddle_tpu/text`): the
model zoo (GPT, BERT, ERNIE), the synthetic LM datasets, the reference's
datasets over local archives, and Viterbi decoding."""
from . import models  # noqa: F401
from .datasets import FakeTextDataset, LMDataset  # noqa: F401
from .datasets_ref import (  # noqa: F401
    Conll05st, Imdb, Imikolov, Movielens, UCIHousing, WMT14, WMT16)
from .viterbi import ViterbiDecoder, viterbi_decode  # noqa: F401
