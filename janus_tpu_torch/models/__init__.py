"""CRDT type models (counterpart: janus_tpu/models).

Each type module registers its ``CRDTTypeSpec`` when imported; import
the type module itself (``janus_tpu_torch.models.pncounter``). This
package imports only ``base``, which the kernels' plain versions share.
"""

from janus_tpu_torch.models import base  # noqa: F401
