"""Plain reference of the ``field_hash`` configuration: one scene's
hash-grid field (instant-ngp's encoding, f32 MLPs), its first call of rgb
steps and the refresh that ends it (``fields.py``)."""
from benchmark.reference.fields import readings  # noqa: F401
