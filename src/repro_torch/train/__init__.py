from repro_torch.train.loop import TrainLoop, make_train_step

__all__ = ["TrainLoop", "make_train_step"]
