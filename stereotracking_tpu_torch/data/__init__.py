from .coco_video import CocoVideo  # noqa: F401
from .dancetrack import DanceTrackDataset  # noqa: F401
from .datasets import (CocoDispDataset, MOTDispDataset,  # noqa: F401
                       MOTKittiDataset)
from .loader import PrefetchIterator  # noqa: F401
