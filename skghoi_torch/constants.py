"""Behavioral constants of the SCG HOI network, pinned from the reference.

The port's own copy of the values its modules use; each cites the reference
file:line (relative to the upstream SKGHOI checkout) that defines it.
"""

# Dataset class counts (hicodet/hicodet.py:72-74)
HICO_NUM_OBJECTS = 80
HICO_NUM_VERBS = 117
HICO_NUM_INTERACTIONS = 600
HICO_HUMAN_IDX = 49

VCOCO_NUM_ACTIONS = 24
VCOCO_HUMAN_IDX = 1

# Detection filtering (heads/adamixer_transH_spatial_r50_head.py:66-71,119-142)
BOX_SCORE_THRESH = 0.2
BOX_NMS_THRESH = 0.5
MAX_HUMAN = 15
MAX_OBJECT = 15
MAX_BOXES = MAX_HUMAN + MAX_OBJECT          # 30 slots, humans packed first

# Padded capacity of the raw detections entering the filter (a cached
# detection JSON holds <=100 boxes) and of the ground-truth pairs an image.
MAX_RAW_DETECTIONS = 128
MAX_GT_PAIRS = 32

# Image transform (models/adamixer_transH_spatial_r50_models.py:134,193-198):
# short side to 800, long side at most 1333, pasted into a fixed canvas by
# orientation (multiples of 32 that cover that envelope).
IMAGE_MIN_SIZE = 800
IMAGE_MAX_SIZE = 1333
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)
CANVAS_LANDSCAPE = (832, 1344)
CANVAS_PORTRAIT = (1344, 832)

# Model dimensions (heads/...head.py:635-701; models/...models.py:115-177)
FPN_CHANNELS = 256
FPN_STRIDES = (4, 8, 16, 32)
ROI_POOL_SIZE = 7
ROI_SAMPLING_RATIO = 2
NODE_ENCODING_SIZE = 1024
REPRESENTATION_SIZE = 1024
MBF_CARDINALITY = 16
SPATIAL_FEATURE_SIZE = 46                   # ops.py:134-156 (23 features + log)
SPATIAL_HIDDEN = (128, 256, 1024)           # heads/...head.py:662-669
NUM_MP_ITERATIONS = 2                        # configures/.../main.py:149

# TransH head (heads/...head.py:685-692; heads/TransH/TransH.py:10-22)
TRANSH_DIM = 50
TRANSH_P_NORM = 2
TRANSH_NORM_FLAG = True
TRANSH_MARGIN = 1.0                          # heads/...head.py:230

# Losses (heads/...head.py:153-235; ops.py:159-203)
FOCAL_ALPHA = 0.5
FOCAL_GAMMA_HOI = 0.2
FOCAL_GAMMA_INTERACTIVENESS = 2.0
FOCAL_EPS = 1e-6
FG_IOU_THRESH = 0.5                          # heads/...head.py:604,711-714
MAX_TRANSH_PAIRS = 64  # cap of sampled TransH positives (and negatives) an image; keeps shapes static

# Prior-score exponent: 1.0 during training, 2.8 at inference (heads/...head.py:742)
PRIOR_POWER_TRAIN = 1.0
PRIOR_POWER_EVAL = 2.8

# Training schedule (configures/.../main.py:122-166)
LEARNING_RATE = 1e-4
LR_DECAY_BACKBONE = 0.1
WEIGHT_DECAY = 1e-4
LR_MILESTONE_EPOCH = 6
LR_MILESTONE_GAMMA = 0.1

# Spatial-encoding numerical epsilon (ops.py:87)
SPATIAL_EPS = 1e-10
