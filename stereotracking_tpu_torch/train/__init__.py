"""The detector's training path: the schedule, SimOTA and the YOLOX
losses, the train state and step, and train checkpoints (the port of
``stereotracking_tpu/train``)."""
