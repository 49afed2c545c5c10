"""htdemucs_6s as published, in plain float32 PyTorch: the plain reference of
the ``shipped`` configuration, loaded as ``reference.models.htdemucs`` in place
of the shared ``reference/models/htdemucs.py`` (``configs/shipped.json``,
``reference_modules``). It imports nothing of the program.

The architecture is HTDemucs (Rouard, Massa and Defossez, "Hybrid
Transformers for Music Source Separation", arXiv:2211.08553; demucs v4,
``demucs/htdemucs.py::HTDemucs`` and ``demucs/transformer.py::
CrossTransformerEncoder``). Everything but two definitions is the shared
reference's code, run in this module's namespace: its net, its separation
program and its loaders.

**The layer order** is demucs' ``t_cross_first=False``
(``classic_parity = 1``): layers 0, 2 and 4 self-attend, layers 1 and 3
cross-attend, the spectral tokens attending to the time tokens and the other
way round. ``HTDemucs`` here reads each layer's kind from its parameters
(``norm3_g`` present: cross-attention), where the shared one builds cross
layers at the even indices; ``init_params`` makes the published order.

Normalisation statistics and the softmax are float32, GELU is exact and
attention is matmul + softmax; TF32 stays off, as the check sets it.
``bf16=True`` runs the net under bf16 autocast, for the lower-precision
control of ``readings.py`` only.

**Departures from demucs**, all of them the separation program's own, which
the port takes from the JAX package and this file follows:

- the song is mono at 22.05 kHz: it is upsampled 2x to 44.1 kHz (a windowed
  sinc half-band filter as frame @ banded matrix), made pseudo-stereo (the
  mono signal on both channels), and the stems' channel mean is decimated
  back to 22.05 kHz;
- the window is 7.8 s rounded up to a multiple of 1,024 samples (344,064)
  and the stride 3/4 of it rounded down to one (258,048), where demucs cuts
  343,980-sample windows 257,985 apart;
- the overlap-add weighs each window by ``linspace(0.1, 1)`` up and down
  again, where demucs weighs ``1 ... segment / 2`` normalised to a peak of 1;
- the first shift is 0 and a further shift ``i`` is ``i * 0.5 s / shifts``,
  where demucs draws every shift at random in ``[0, 0.5 s]``;
- ``init_params`` draws He-scaled weights and a sinusoidal frequency
  embedding from a seed (demucs' own initialisation is not reproduced), with
  the transformer's LayerScale given as ``layer_scale`` (demucs starts it at
  1e-4; a trained model's is far from that).
"""

from __future__ import annotations

import functools
from pathlib import Path

# The shared reference's code, run here and not imported: the check wraps
# this module's ``separate_program`` by name (``core/check.py``), so the
# functions that call it, and those that build ``HTDemucs`` or call
# ``init_params``, must look both up in this module, where the two
# definitions below replace the shared ones.
_doc = __doc__
_SHARED = Path(__file__).resolve().parents[1] / "reference" / "models" / "htdemucs.py"
exec(compile(_SHARED.read_text(), str(_SHARED), "exec"))
__doc__ = _doc

_SharedHTDemucs, _shared_init_params = HTDemucs, init_params  # noqa: F821 (defined by the shared code)


class HTDemucs(_SharedHTDemucs):
    """The shared net with its transformer layers' kinds given:
    ``cross_layers`` are the indices that cross-attend, in both branches."""

    def __init__(self, *, bottom: int, t_ff: int, t_layers: int, cross_layers: list[int], **widths):
        super().__init__(bottom=bottom, t_ff=t_ff, t_layers=t_layers, **widths)
        kinds = [i in cross_layers for i in range(t_layers)]
        self.tlayers = nn.ModuleList(TransformerLayer(bottom, t_ff, cross=c) for c in kinds)  # noqa: F821
        self.tlayers_t = nn.ModuleList(TransformerLayer(bottom, t_ff, cross=c) for c in kinds)  # noqa: F821

    @classmethod
    def from_params(cls, params: dict) -> HTDemucs:
        """The shared ``from_params``, with each layer's kind read off the
        pytree (``norm3_g`` present: cross-attention)."""
        cross_layers = [i for i, layer in enumerate(params["tlayers"]) if "norm3_g" in layer]
        return _SharedHTDemucs.from_params.__func__(functools.partial(cls, cross_layers=cross_layers), params)


def init_params(generator, *args, layer_scale: float = 1e-4, **widths) -> dict:
    """The shared ``init_params`` in the published order (cross-attention, and
    its ``norm3`` of ones and zeros, at the odd layers), with the
    transformer's LayerScale at ``layer_scale``. The shared init draws every
    He weight in one call of ``generator``, and a layer's kind adds no draw,
    so the order moves no weight."""
    p = _shared_init_params(generator, *args, **widths)
    for branch in ("tlayers", "tlayers_t"):
        for i, layer in enumerate(p[branch]):
            layer.pop("norm3_g", None)
            layer.pop("norm3_b", None)
            if i % 2 == 1:
                layer["norm3_g"], layer["norm3_b"] = np.ones_like(layer["norm1_g"]), np.zeros_like(layer["norm1_b"])  # noqa: F821
            layer["gamma1"] = np.full_like(layer["gamma1"], layer_scale)  # noqa: F821
            layer["gamma2"] = np.full_like(layer["gamma2"], layer_scale)  # noqa: F821
    return p
