"""The Layers of `paddle_tpu_torch.nn` (counterpart of
`paddle_tpu/nn/layer`)."""
