"""Host data layer: numpy + PIL augmentation, the C++ train augmenter, the
YOLO dataset, split and synthetic-set tooling, and the threaded loader."""
