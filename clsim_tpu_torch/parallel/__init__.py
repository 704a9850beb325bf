"""Multi-event orchestration (pipeline.EventPipeline) and the ice fit
(mesh.IceFit)."""

from .pipeline import EventPipeline, EventResult  # noqa: F401
