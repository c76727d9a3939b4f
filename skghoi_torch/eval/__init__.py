"""HICO-DET mAP evaluation and the official evaluators' result caches."""
