"""paddle.onnx (reference: python/paddle/onnx/export.py — delegates to the
external paddle2onnx package).

Counterpart of `paddle_tpu/onnx/__init__.py`. The port's serialized
program is a `torch.export` program (`jit.save`), and the JAX package
has no ONNX exporter either: ONNX export would need an out-of-repo
converter exactly as the reference requires paddle2onnx, so export()
raises and names the supported route.
"""

__all__ = ["export"]


def export(layer, path, input_spec=None, opset_version=9, **configs):
    raise RuntimeError(
        "ONNX export needs the external paddle2onnx-equivalent converter "
        "(the reference delegates too, python/paddle/onnx/export.py). "
        "The port's serving artifact is a torch.export program: use "
        "paddle_tpu_torch.jit.save(layer, path, input_spec) and serve it "
        "with paddle_tpu_torch.inference.create_predictor")
