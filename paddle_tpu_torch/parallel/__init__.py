"""Training and its parallel layout: the train-step builder
(`train.py`), the device mesh (`mesh.py`), logical-axis rules
(`sharding.py`), the rings that carry a mesh axis (`ring.py`) and the
GPipe pipeline over `pp` (`pipeline.py`)."""
