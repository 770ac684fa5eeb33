"""Plain reference of the ``fleet_hash`` configuration: B scenes' hash-grid
fields as one batched computation (bf16 MLPs), the first call of rgb
steps and the subsampled refresh that ends it (``fields.py``)."""
from benchmark.reference.fields import readings  # noqa: F401
