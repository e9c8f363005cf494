"""Training: AdamW, the train step and loop, gradient compression (the
port of the reference's ``repro.training``)."""
from .grad_compression import (compressed_grad_sync, compressed_mean,
                               dequantize_int8, init_residuals,
                               quantize_int8)
from .optimizer import (AdamWConfig, adamw_init, adamw_update,
                        clip_by_global_norm, global_norm, lr_schedule)
from .train_loop import (StragglerWatchdog, TrainLoop, loss_and_grads,
                         make_train_step, sync_grads)

__all__ = ["AdamWConfig", "adamw_init", "adamw_update",
           "clip_by_global_norm", "global_norm", "lr_schedule",
           "make_train_step", "loss_and_grads", "sync_grads", "TrainLoop",
           "StragglerWatchdog", "quantize_int8", "dequantize_int8",
           "compressed_mean", "compressed_grad_sync", "init_residuals"]
