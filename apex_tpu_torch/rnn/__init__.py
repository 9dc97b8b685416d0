"""RNNs (counterpart of ``apex_tpu.rnn``, Apex's ``apex.RNN``): the
LSTM, mLSTM, GRU, ReLU and tanh cells and the stacked, bidirectional
models over them."""

from apex_tpu_torch.rnn import cells, models
from apex_tpu_torch.rnn.models import (
    GRU,
    LSTM,
    ReLU,
    Tanh,
    mLSTM,
    params_from_numpy,
)

__all__ = ["LSTM", "GRU", "ReLU", "Tanh", "mLSTM", "cells", "models",
           "params_from_numpy"]
