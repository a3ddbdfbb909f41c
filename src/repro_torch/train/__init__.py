from .step import make_train_step, make_eval_step, loss_fn
