"""The VO engines, the offline pipelines, online VO and refinement. Mirrors
``vo_tpu/engine/__init__.py``; importing it builds no kernel."""

from vo_tpu_torch.engine.vo import VOConfig, VOEngine, VOState, VOStepDiagnostics
