"""Host->device transfer helpers.

bf16 uploads ship the bits as a uint16 VIEW and restore the bf16 dtype on
device with a zero-cost ``bitcast_convert_type``: ``device_put`` of an
ml_dtypes-bfloat16 numpy array took a slow path on the previous
accelerator. Whether the GPU needs the detour is not measured; ROADMAP
Queue 3 #2 removes it once a ledger run shows it buys nothing. All bf16
uploads in the codebase go through here.
"""
from __future__ import annotations

import numpy as np


def put_bf16(host: np.ndarray):
    """Upload ``host`` (float32 or ml_dtypes bfloat16) as a device bf16
    array via the u16 view. f32 inputs are converted on the host first —
    half the bytes of shipping f32."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    if host.dtype != ml_dtypes.bfloat16:
        host = np.asarray(host, np.float32).astype(ml_dtypes.bfloat16)
    u16 = np.ascontiguousarray(host).view(np.uint16)
    return jax.lax.bitcast_convert_type(jax.device_put(u16), jnp.bfloat16)


_WRITE_BLOCK = None


def _write_block_fn():
    global _WRITE_BLOCK
    if _WRITE_BLOCK is None:
        from functools import partial

        import jax

        @partial(jax.jit, donate_argnums=(0,))
        def write(buf, blk, lo):
            return jax.lax.dynamic_update_slice(buf, blk, (lo, 0))

        _WRITE_BLOCK = write
    return _WRITE_BLOCK


def put_bf16_blocks(src: np.ndarray, n_rows: int,
                    block_bytes: int = 256 << 20):
    """Assemble an [n_rows, dim] bf16 device mirror from host rows in
    ~``block_bytes`` pieces (u16-view fast path per piece, donated
    device-side writes — no whole-mirror copies).

    Unlike one monolithic ``put_bf16``, each block marks progress
    (utils.progress), and the full bf16 host twin (7.7 GB at 10M x 384)
    is never materialized — only one block is ever resident."""
    import jax
    import jax.numpy as jnp
    import ml_dtypes

    from . import progress

    n_rows = int(n_rows)
    dim = int(src.shape[1])
    rows_per = max(int(block_bytes) // (dim * 2), 1)
    write = _write_block_fn()
    mirror = jnp.zeros((n_rows, dim), jnp.bfloat16)
    for lo in range(0, n_rows, rows_per):
        hi = min(lo + rows_per, n_rows)
        blk = np.asarray(src[lo:hi], np.float32).astype(ml_dtypes.bfloat16)
        dev = jax.lax.bitcast_convert_type(
            jax.device_put(blk.view(np.uint16)), jnp.bfloat16)
        mirror = write(mirror, dev, jnp.int32(lo))
        progress.mark()  # one block uploaded
    return mirror
