"""Dataset schema constants for the soft-tissue-sarcoma cohort.

A copy of the parts of the JAX package's constants.py that this package
uses: the column lists behind the config defaults, the cohort-build and
split constants, the MRI intensity statistics of the transforms, the
survival super-batch, the classification threshold and the bootstrap's
resample count. The YAML config can override the column lists.
"""

HEADERS_TO_CONVERT = [
    "Sex",
    "Location3",
    "Diagnosis",
    "Chemo (Neoadjuvant)",
]

PRE_OP_PREDICTORS = [
    "Sex",
    "Age",
    "Location3",
    "Diagnosis",
    "Chemo (Neoadjuvant)",
    "TumorSize",
    "TumorVolume (cm^3)",
    "TumorDepth (1 = deep to fascia, 0 = superficial) ",
    "TumorGrade",
    "Metsatpresentation",
    "RT Type (0 = preop, 1 = postop",
]

POST_OP_PREDICTORS = [
    "Margin (negative==0, microscopically positive==1, grossly positive==2)",
    "Necrosis % (information not known prior to operation)",
    "LengthOR",
]

STRATIFY_BY = [
    "RT Type (0 = preop, 1 = postop",
    "Location3",
    "TumorGrade",
    "VolumeCutoff",
]

TARGETS_BINARY = [
    "VitalStatus",
    "Distant metastasis",
]

TARGETS_TIME = [
    "FUtime",
    "Date of Distant Mets",
    "Surgery_Date",
]

NECROSIS_COLUMN = "Necrosis % (information not known prior to operation)"
TUMOR_VOLUME_COLUMN = "TumorVolume (cm^3)"

RADIOMICS_EXCLUDE_COLUMNS = [
    "diagnostics_Versions_PyRadiomics",
    "diagnostics_Versions_Numpy",
    "diagnostics_Versions_SimpleITK",
    "diagnostics_Versions_PyWavelet",
    "diagnostics_Versions_Python",
    "diagnostics_Configuration_Settings",
    "diagnostics_Configuration_EnabledImageTypes",
    "diagnostics_Image-original_Hash",
    "diagnostics_Image-original_Dimensionality",
    "diagnostics_Image-original_Spacing",
    "diagnostics_Image-original_Size",
    "diagnostics_Image-original_Mean",
    "diagnostics_Image-original_Minimum",
    "diagnostics_Image-original_Maximum",
    "diagnostics_Mask-original_Hash",
    "diagnostics_Mask-original_Spacing",
    "diagnostics_Mask-original_Size",
    "diagnostics_Mask-original_BoundingBox",
    "diagnostics_Mask-original_VoxelNum",
    "diagnostics_Mask-original_VolumeNum",
    "diagnostics_Mask-original_CenterOfMassIndex",
    "diagnostics_Mask-original_CenterOfMass",
]

RADIOMICS_LABEL_COLUMNS = [
    "VitalStatus",
    "Distant metastasis",
]

RADIOMICS_SURV_LABEL_COLUMNS = [
    "FUtime",
    "Time_MET",
]

UID = "MRN"
ANON_UID = "Anon MRN"

# (event-indicator column, duration column) pairs defining the two
# time-to-event targets: overall survival (VS/OS) and distant metastasis (DM).
HEADER_PAIRS = [
    ("VitalStatus", "FUtime"),
    ("Distant metastasis", "Time_MET"),
]

# Intensity statistics of the cohort's MRI volumes.
IMAGE_DATA_MEAN = 286.90859071507913
IMAGE_DATA_STDDEV = 581.7816096485366

NUM_CLASSES = 2

SPATIAL_SIZE = (64, 64, 64)
# a sigmoid probability above this is a positive prediction
CLASSIFICATION_THRESHOLD = 0.5
# resamples of the bootstrap C-index confidence intervals
NUM_BOOTSTRAP_ITERATIONS = 50
# survival optimizer step: 64 samples as accumulated microbatches
SUPER_BATCH_SIZE = 64
