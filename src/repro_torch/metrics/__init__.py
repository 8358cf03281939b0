from repro_torch.metrics.resources import StageMetrics, StageProbe

__all__ = ["StageMetrics", "StageProbe"]
