"""Data: COCO / CrowdPose keypoint datasets, augmentations, the batch loader
and the OKS AP evaluator (host-side numpy and PIL; the loader's pool workers
import these modules and no torch)."""
from .coco import CocoKeypointDataset
from .evaluator import KeypointEvaluator

__all__ = ["CocoKeypointDataset", "KeypointEvaluator"]
