"""KV-block wire format for handing a request's prefill from one engine to
another.

The port's copy of `paddle_tpu/serving/distributed/kv_handoff.py`, numpy,
`struct` and `json` only. A prefill engine computes a request's K/V in its
pool; what crosses the wire is a KV bundle: the per-layer [tokens, heads,
head_dim] K and V slices of that request (block padding stripped: only the
`plen` real tokens ship) plus the metadata the receiver needs to adopt
them (`first_token`, `plen`). The receiver scatters the bundle into blocks
of its own pool (`engine.adopt_kv`) and decodes on as a local prefill
would.

Wire layout (little-endian):

    u32 MAGIC ("KVB1") | u32 header_len | header JSON | L * (K | V)

The header is `json.dumps(header)` with the default separators and key
order of the reference, so a bundle the port packs is byte for byte the
bundle the JAX package packs from the same arrays and meta. It carries
{v, dtype, layers, tokens, heads, head_dim, meta} and pins the byte count
of the array tail, so a truncation or a shape lie fails
`unpack_kv_bundle` with `KVWireError`.

  * v1: float K/V.
  * v2: int8 codes with their per-source-block, per-head float32 scales,
    L * (K | V | Kscale | Vscale), and `scale_block` (the tokens one scale
    row covers) and `scale_blocks` in the header; unpack dequantizes, so
    the adopting side never sees the layout.
  * v3: either layout plus {"rng": {"seed", "gen"}}, the request's sampler
    state after its first token, so a sampled stream continues across the
    handoff.

`pack_payload`/`unpack_payload` are the lighter framing of the control
verbs: a JSON object and an opaque binary tail in one length-prefixed
payload.

The `serving.kv_handoff` fault site fires at both ends, first thing in
`pack_kv_bundle` (the sender) and in `unpack_kv_bundle` (the receiver),
as in the reference: a raise on either end leaves the caller to fall back
to a local prefill.
"""
import json
import struct

import numpy as np

from ...observability import faults as _faults

__all__ = ["KVWireError", "BUNDLE_VERSION", "QUANT_BUNDLE_VERSION",
           "RNG_BUNDLE_VERSION", "pack_kv_bundle", "unpack_kv_bundle",
           "pack_payload", "unpack_payload"]

BUNDLE_VERSION = 1            # float bundles: L * (K | V)
QUANT_BUNDLE_VERSION = 2      # int8 codes + per-block per-head scales
RNG_BUNDLE_VERSION = 3        # either layout + the sampler's (seed, gen)
QMAX = 127.0                  # `serving.blocks.QMAX`
_MAGIC = 0x3142564B           # "KVB1" little-endian
_U32 = struct.Struct("<I")
_HEAD = struct.Struct("<II")  # magic | header_len


class KVWireError(ValueError):
    """A KV bundle failed wire validation (truncated frame, shape or dtype
    lie, foreign magic): never a torn adoption."""


def _dequant_codes(codes, scale_b):
    """numpy copy of `serving.blocks.dequant_codes`, the one dequant
    expression: `code * (scale / QMAX)` in float32, multiplication order
    included."""
    return np.asarray(codes).astype(np.float32) * (
        np.asarray(scale_b, np.float32) / np.float32(QMAX))


def pack_kv_bundle(ks, vs, meta=None, k_scales=None, v_scales=None,
                   scale_block=None, rng=None):
    """Serialize one request's per-layer K/V slices.

    ks/vs: sequences of [tokens, heads, head_dim] arrays, one per layer,
    all of one shape and dtype (`engine.extract_kv`). `meta` is a small
    JSON-able dict that rides the header verbatim.

    Quantized (v2) bundles: int8 ks/vs with `k_scales`/`v_scales` (per
    layer [scale_blocks, heads] float32, the pool's per-block per-head
    scales, `engine.extract_kv_wire`) and `scale_block` (tokens each scale
    row covers).

    `rng=(seed, gen)` stamps the bundle v3: the request's sampler state
    after its first token. Composes with either layout."""
    _faults.fire("serving.kv_handoff")
    if len(ks) != len(vs) or not ks:
        raise KVWireError(
            f"bundle needs matching non-empty K/V layer lists, got "
            f"{len(ks)}/{len(vs)}")
    quant = (k_scales is not None or v_scales is not None
             or scale_block is not None)
    if quant and (k_scales is None or v_scales is None
                  or scale_block is None):
        raise KVWireError("quantized bundle needs k_scales, v_scales AND "
                          "scale_block together")
    ks = [np.ascontiguousarray(k) for k in ks]
    vs = [np.ascontiguousarray(v) for v in vs]
    shape, dtype = ks[0].shape, ks[0].dtype
    if len(shape) != 3:
        raise KVWireError(f"layer K/V must be [tokens, heads, head_dim], "
                          f"got shape {shape}")
    for arr in ks + vs:
        if arr.shape != shape or arr.dtype != dtype:
            raise KVWireError(
                f"bundle layers disagree: {arr.shape}/{arr.dtype} vs "
                f"{shape}/{dtype}")
    if not quant and dtype == np.int8:
        raise KVWireError("int8 K/V needs k_scales/v_scales/scale_block "
                          "— scale-less codes are not a legal wire")
    header = {
        "v": QUANT_BUNDLE_VERSION if quant else BUNDLE_VERSION,
        "dtype": dtype.name, "layers": len(ks),
        "tokens": int(shape[0]), "heads": int(shape[1]),
        "head_dim": int(shape[2]), "meta": dict(meta or {})}
    if rng is not None:
        header["v"] = RNG_BUNDLE_VERSION
        header["rng"] = {"seed": int(rng[0]), "gen": int(rng[1])}
    parts = [None, None]        # frame head + header, filled below
    if quant:
        if dtype != np.int8:
            raise KVWireError(
                f"quantized bundle K/V must be int8, got {dtype}")
        sb = int(scale_block)
        if sb < 1:
            raise KVWireError(f"scale_block must be >= 1, got {sb}")
        nsb = -(-int(shape[0]) // sb)     # ceil(tokens / scale_block)
        sshape = (nsb, int(shape[1]))
        k_scales = [np.ascontiguousarray(s, np.float32) for s in k_scales]
        v_scales = [np.ascontiguousarray(s, np.float32) for s in v_scales]
        if len(k_scales) != len(ks) or len(v_scales) != len(vs):
            raise KVWireError(
                f"scale count mismatch: {len(k_scales)}/{len(v_scales)} "
                f"scale arrays for {len(ks)} layers")
        for s in k_scales + v_scales:
            if s.shape != sshape:
                raise KVWireError(
                    f"scale shape {s.shape} != {sshape} "
                    f"(ceil(tokens/scale_block) x heads)")
        header["scale_block"] = sb
        header["scale_blocks"] = nsb
        for k, v, sk, sv in zip(ks, vs, k_scales, v_scales):
            parts += [_raw(k), _raw(v), _raw(sk), _raw(sv)]
    else:
        for k, v in zip(ks, vs):
            parts += [_raw(k), _raw(v)]
    blob = json.dumps(header).encode()
    parts[0] = _HEAD.pack(_MAGIC, len(blob))
    parts[1] = blob
    return b"".join(parts)


def _raw(arr):
    """The bytes of a C-contiguous array as a view (what `tobytes()`
    returns, without its copy: the join below makes the one copy)."""
    return arr.reshape(-1).view(np.uint8)


def unpack_kv_bundle(buf):
    """(ks, vs, meta) from `pack_kv_bundle` bytes. Raises KVWireError on
    anything that does not verify: the header pins the exact byte count,
    so a truncated tail never yields a short but plausible bundle. A
    quantized bundle comes back dequantized to float32, with
    meta["quantized"] = True; a v3 bundle adds meta["rng"] = (seed,
    gen)."""
    _faults.fire("serving.kv_handoff")
    buf = memoryview(bytes(buf) if not isinstance(buf, (bytes, bytearray,
                                                        memoryview))
                     else buf)
    if len(buf) < _HEAD.size:
        raise KVWireError(f"bundle truncated: {len(buf)} bytes is shorter "
                          f"than the {_HEAD.size}-byte frame head")
    magic, hlen = _HEAD.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise KVWireError(f"bad bundle magic {magic:#x}")
    if len(buf) < _HEAD.size + hlen:
        raise KVWireError("bundle truncated inside the header")
    try:
        header = json.loads(bytes(buf[_HEAD.size:_HEAD.size + hlen]))
    except ValueError as e:
        raise KVWireError(f"bundle header is not JSON: {e}") from None
    version = header.get("v")
    if version not in (BUNDLE_VERSION, QUANT_BUNDLE_VERSION,
                       RNG_BUNDLE_VERSION):
        raise KVWireError(f"bundle version {version!r}, want "
                          f"{BUNDLE_VERSION}..{RNG_BUNDLE_VERSION}")
    # v3 keeps either layout: the scale header fields decide
    quant = version == QUANT_BUNDLE_VERSION or (
        version == RNG_BUNDLE_VERSION and "scale_block" in header)
    try:
        dtype = np.dtype(header["dtype"])
        layers = int(header["layers"])
        shape = (int(header["tokens"]), int(header["heads"]),
                 int(header["head_dim"]))
    except (KeyError, TypeError, ValueError) as e:
        raise KVWireError(f"bundle header malformed: {e}") from None
    if layers < 1 or min(shape) < 1:
        raise KVWireError(f"bundle header degenerate: layers={layers}, "
                          f"shape={shape}")
    per = int(np.prod(shape)) * dtype.itemsize
    sper, sshape, sb = 0, None, 0
    if not quant and dtype == np.int8:
        raise KVWireError("float-layout bundle carries int8 K/V — "
                          "quantized bundles must carry scales")
    if quant:
        if dtype != np.int8:
            raise KVWireError(
                f"quantized bundle dtype {dtype}, must be int8")
        try:
            sb = int(header["scale_block"])
            nsb = int(header["scale_blocks"])
        except (KeyError, TypeError, ValueError) as e:
            raise KVWireError(
                f"quantized bundle header malformed: {e}") from None
        if sb < 1 or nsb != -(-shape[0] // sb):
            raise KVWireError(
                f"scale count mismatch: {nsb} scale rows of {sb} tokens "
                f"cannot cover {shape[0]} tokens")
        sshape = (nsb, shape[1])
        sper = int(np.prod(sshape)) * 4          # float32 scales
    want = _HEAD.size + hlen + layers * 2 * (per + sper)
    if len(buf) != want:
        raise KVWireError(
            f"bundle truncated or padded: {len(buf)} bytes, header "
            f"demands {want} ({layers} layers x 2 x {per + sper}B)")
    ks, vs = [], []
    off = _HEAD.size + hlen
    count = int(np.prod(shape))
    for _ in range(layers):
        k = np.frombuffer(buf, dtype, count=count, offset=off).reshape(shape)
        off += per
        v = np.frombuffer(buf, dtype, count=count, offset=off).reshape(shape)
        off += per
        if quant:
            scount = int(np.prod(sshape))
            sk = np.frombuffer(buf, np.float32, count=scount,
                               offset=off).reshape(sshape)
            off += sper
            sv = np.frombuffer(buf, np.float32, count=scount,
                               offset=off).reshape(sshape)
            off += sper
            k = _dequant_tokens(k, sk, sb)
            v = _dequant_tokens(v, sv, sb)
        ks.append(k)
        vs.append(v)
    meta = header.get("meta", {})
    if quant:
        meta = dict(meta, quantized=True)
    rng_h = header.get("rng")
    if rng_h is not None:
        try:
            meta = dict(meta, rng=(int(rng_h["seed"]), int(rng_h["gen"])))
        except (KeyError, TypeError, ValueError) as e:
            raise KVWireError(f"bundle rng field malformed: {e}") from None
    return ks, vs, meta


def _dequant_tokens(codes, scales, scale_block):
    """[tokens, h, d] int8 codes + [nsb, h] per-source-block scales -> f32
    tokens: token t dequantizes against scale row t // scale_block."""
    rows = np.arange(codes.shape[0]) // scale_block
    return _dequant_codes(codes, scales[rows][:, :, None])


def pack_payload(obj, tail=b""):
    """`u32 json_len | json | tail`: the framing the control verbs share."""
    blob = json.dumps(obj).encode()
    return _U32.pack(len(blob)) + blob + bytes(tail)


def unpack_payload(body):
    """(obj, tail bytes) from `pack_payload` output."""
    body = bytes(body)
    if len(body) < _U32.size:
        raise KVWireError("payload truncated before the JSON length")
    (jlen,) = _U32.unpack_from(body, 0)
    if len(body) < _U32.size + jlen:
        raise KVWireError("payload truncated inside the JSON head")
    try:
        obj = json.loads(body[_U32.size:_U32.size + jlen])
    except ValueError as e:
        raise KVWireError(f"payload head is not JSON: {e}") from None
    return obj, body[_U32.size + jlen:]
