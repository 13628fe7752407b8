"""The training step (``train_step.py``) and its data parallelism over ranks
(``dist.py``, ``mesh.py``). The package imports none of them: the models
and the criterion import ``dist.py``, and the step imports them."""
