"""Containers (counterpart of `paddle_tpu/nn/layer/container.py`):
`Sequential`, `LayerList`, `LayerDict`, `ParameterList`."""
from collections import OrderedDict

from .layers import Layer

__all__ = ["Sequential", "LayerList", "ParameterList", "LayerDict"]


class Sequential(Layer):
    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], OrderedDict):
            for name, l in layers[0].items():
                self.add_sublayer(name, l)
        elif len(layers) > 0 and isinstance(layers[0], (list, tuple)) and not \
                isinstance(layers[0], Layer):
            for name, l in layers:
                self.add_sublayer(name, l)
        else:
            for i, l in enumerate(layers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return Sequential(*list(self._sub_layers.values())[idx])
        keys = list(self._sub_layers.keys())
        return self._sub_layers[keys[idx]]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def forward(self, x):
        for layer in self._sub_layers.values():
            x = layer(x)
        return x


class LayerList(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            for i, l in enumerate(sublayers):
                self.add_sublayer(str(i), l)

    def __getitem__(self, idx):
        if isinstance(idx, slice):
            return LayerList(list(self._sub_layers.values())[idx])
        keys = list(self._sub_layers.keys())
        return self._sub_layers[keys[idx]]

    def __setitem__(self, idx, layer):
        keys = list(self._sub_layers.keys())
        self._sub_layers[keys[idx]] = layer

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers.values())

    def append(self, layer):
        self.add_sublayer(str(len(self._sub_layers)), layer)
        return self

    def insert(self, index, layer):
        layers = list(self._sub_layers.values())
        layers.insert(index, layer)
        self._sub_layers.clear()
        for i, l in enumerate(layers):
            self._sub_layers[str(i)] = l
        return self

    def extend(self, layers):
        for l in layers:
            self.append(l)
        return self


class ParameterList(Layer):
    def __init__(self, parameters=None):
        super().__init__()
        if parameters is not None:
            for i, p in enumerate(parameters):
                self.add_parameter(str(i), p)

    def __getitem__(self, idx):
        keys = list(self._parameters.keys())
        return self._parameters[keys[idx]]

    def __len__(self):
        return len(self._parameters)

    def __iter__(self):
        return iter(self._parameters.values())

    def append(self, parameter):
        self._parameters[str(len(self._parameters))] = parameter
        return self


class LayerDict(Layer):
    def __init__(self, sublayers=None):
        super().__init__()
        if sublayers is not None:
            self.update(sublayers)

    def __getitem__(self, key):
        return self._sub_layers[key]

    def __setitem__(self, key, layer):
        self.add_sublayer(key, layer)

    def __delitem__(self, key):
        del self._sub_layers[key]

    def __len__(self):
        return len(self._sub_layers)

    def __iter__(self):
        return iter(self._sub_layers)

    def __contains__(self, key):
        return key in self._sub_layers

    def clear(self):
        self._sub_layers.clear()

    def pop(self, key):
        layer = self._sub_layers.pop(key)
        return layer

    def keys(self):
        return self._sub_layers.keys()

    def items(self):
        return self._sub_layers.items()

    def values(self):
        return self._sub_layers.values()

    def update(self, sublayers):
        items = sublayers.items() if isinstance(
            sublayers, (dict, OrderedDict, LayerDict)) else sublayers
        for key, layer in items:
            self.add_sublayer(key, layer)
        return self
