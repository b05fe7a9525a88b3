from vo_tpu_torch.features.detect import harris_response, shi_tomasi_response, detect_keypoints
from vo_tpu_torch.features.brief import oriented_brief_descriptors, brief_offsets
from vo_tpu_torch.features.extractor import OrbLikeExtractor, Features
