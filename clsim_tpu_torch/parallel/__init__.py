"""Multi-event orchestration (pipeline.EventPipeline), photon sharding over
ranks (mesh.make_sharded_propagate, bootstrap) and the ice fit
(mesh.IceFit)."""

from .pipeline import EventPipeline, EventResult  # noqa: F401
from .mesh import (PHOTON_AXIS, IceFit, PhotonMesh,  # noqa: F401
                   make_mesh, make_sharded_propagate, shard_steps)
from .bootstrap import (global_photon_mesh,  # noqa: F401
                        initialize_distributed, process_step_slice)
