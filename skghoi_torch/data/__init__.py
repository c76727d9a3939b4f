"""Datasets (HICO-DET / V-COCO), transforms, the padded batch pipeline and
its fixed-shape containers."""
