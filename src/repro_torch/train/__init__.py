from repro_torch.train.loop import (  # noqa: F401
    TrainState,
    init_train_state,
    make_train_step,
    run_training,
)
