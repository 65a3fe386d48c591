from .clear_identity_hota import (VideoData, clear_metrics,  # noqa: F401
                                  combine_videos, hota_metrics,
                                  identity_metrics)
from .coco_metric import CocoMAPEvaluator  # noqa: F401
from .kitti_protocol import KittiEvaluator  # noqa: F401
from .mot_metrics import (MOTChallengeMetrics, MOTDroneMetrics,  # noqa: F401
                          MOTKittiMetrics)
from .aflink import AFLinkModel, AppearanceFreeLink  # noqa: F401
from .postprocess import interpolate_tracklets  # noqa: F401
