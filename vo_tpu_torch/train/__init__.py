from vo_tpu_torch.train.pairs import (random_homography, warp_pair, synthetic_pair_batch,
                                      photometric_augment, pair_batch_from_images)
from vo_tpu_torch.train.losses import cosim_loss, peaky_loss, ap_reliability_loss, r2d2_loss
from vo_tpu_torch.train.trainer import (TrainConfig, TrainState, create_train_state,
                                        train_step, train_step_batch,
                                        save_checkpoint, load_checkpoint)
