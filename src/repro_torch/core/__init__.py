"""The port's own copy of ``repro/core/__init__.py``: the same names, defaults and
arithmetic in the same order; only its imports and cross-references name
``repro_torch``.
"""
# The paper's primary contribution — implement the SYSTEM here
# (scheduler, optimizer, data path, serving loop, etc.) in the
# host framework. Add sibling subpackages for substrates.

from repro_torch.core.topology import TopologyMatrix, preset as topology_preset  # noqa: F401
from repro_torch.core.control import (  # noqa: F401
    ControlConfig,
    DriftDetector,
    HorizonResult,
    HorizonRunner,
    MigrationModel,
    simulate_horizon,
)
from repro_torch.core.fleet import (  # noqa: F401
    FleetConfig,
    FleetJob,
    FleetResult,
    simulate_fleet,
)
