from vo_tpu_torch.matching.matchers import (
    similarity_matrix,
    mutual_nn_match,
    ratio_mutual_nn_match,
    ratio_match,
    MatchResult,
    matches_to_pairs,
)
