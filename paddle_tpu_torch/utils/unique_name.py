"""Process-wide unique name generator with `guard()` scoping
(counterpart of `paddle_tpu/utils/unique_name.py`). `guard(prefix)`
namespaces generated names like the reference's generator switch."""
import contextlib

_STACK = [{"counters": {}, "prefix": ""}]


def generate(key):
    top = _STACK[-1]
    c = top["counters"]
    c[key] = c.get(key, -1) + 1
    return f"{top['prefix']}{key}_{c[key]}"


def generate_with_ignorable_key(key):
    return generate(key)


@contextlib.contextmanager
def guard(new_generator=None):
    prefix = new_generator if isinstance(new_generator, str) else ""
    _STACK.append({"counters": {}, "prefix": prefix})
    try:
        yield
    finally:
        _STACK.pop()


def switch(new_generator=None):
    """Replace the current scope's generator state and return the old one.
    Passing a state returned earlier restores it (pre = switch(); ...;
    switch(pre))."""
    old = _STACK[-1]
    if isinstance(new_generator, dict) and "counters" in new_generator:
        _STACK[-1] = new_generator
    else:
        prefix = new_generator if isinstance(new_generator, str) else ""
        _STACK[-1] = {"counters": {}, "prefix": prefix}
    return old
