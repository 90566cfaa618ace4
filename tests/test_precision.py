"""The float32 matmuls whose rounding the F1 and sub-pixel pins see run
at HIGHEST precision. On the GPU a default-precision float32 matmul may
run in TF32 (about three decimal digits); the CPU computes every
precision exactly, so these tests read the precision from the program."""

import jax
import jax.numpy as jnp
import numpy as np


def _dot_precisions(fn, *args):
    """Precision of every dot_general in fn's program, nested ones too."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in v if isinstance(v, (tuple, list)) else (v,):
                    if hasattr(sub, "eqns"):
                        walk(sub)
                    elif hasattr(sub, "jaxpr") and hasattr(sub.jaxpr, "eqns"):
                        walk(sub.jaxpr)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _all_highest(precisions):
    highest = jax.lax.Precision.HIGHEST
    return bool(precisions) and all(
        p is not None and all(q == highest for q in (p if isinstance(p, tuple) else (p,)))
        for p in precisions
    )


def test_codebook_dot_is_highest():
    from merfish3d_tpu.ops import decode as dec

    cb = dec.normalize_codebook(np.eye(16, dtype=np.float32)[:8] + 1.0)
    found = _dot_precisions(
        dec._decode_chunk, jnp.ones((16, 64), jnp.float32), jnp.asarray(cb.T),
        jnp.zeros(16, jnp.float32), jnp.ones(16, jnp.float32),
    )
    assert len(found) == 1 and _all_highest(found)


def test_upsampled_dft_tensordots_are_highest():
    from merfish3d_tpu.ops.phase_corr import _upsampled_dft

    pair = (jnp.ones((6, 10, 12), jnp.float32), jnp.zeros((6, 10, 12), jnp.float32))
    found = _dot_precisions(
        lambda p, s: _upsampled_dft(p, s, 10), pair, jnp.zeros(3, jnp.float32)
    )
    assert len(found) == 12 and _all_highest(found)


def test_mesh_similarity_einsum_is_highest():
    from merfish3d_tpu.parallel.mesh import decode_pipeline_step

    found = _dot_precisions(
        decode_pipeline_step, jnp.ones((1, 4, 3, 8, 8), jnp.float32),
        jnp.ones((4, 5), jnp.float32), jnp.zeros(4, jnp.float32),
        jnp.ones(4, jnp.float32),
    )
    assert _all_highest(found)
