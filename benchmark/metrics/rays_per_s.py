"""``rays_per_s.<cells>``: rays trained in the window over its seconds on the
host clock (``harness/readers.py:rays_per_s``): ``rays_per_s.fleet`` end to
end, ``rays_per_s.field`` per layer (read in the traced run)."""
from benchmark.harness.readers import rays_per_s


def read(run):
    return rays_per_s(run)
