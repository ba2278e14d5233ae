"""The training losses: detection (YOLOX with SimOTA), segmentation,
point-cloud NLL and the multi-task weightings."""
