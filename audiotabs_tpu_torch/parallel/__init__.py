"""Device meshes: data parallelism over cards and the htdemucs model axis.

Counterpart of audiotabs_tpu/parallel/. One process drives the whole mesh,
as one JAX program does.
"""

from .mesh import Mesh, default_mesh, make_mesh

__all__ = ["Mesh", "make_mesh", "default_mesh"]
