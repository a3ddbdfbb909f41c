from .adamw import AdamWConfig, adamw_init, adamw_update, global_norm, \
    cosine_schedule
