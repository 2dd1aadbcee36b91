"""Data for the port: the paper's synthetic workloads and token stream
(:mod:`repro_torch.data.pipeline`, numpy only) and the committed predictor
parameters, trained (``lstm_predictor.json``) and the training's start
(``lstm_predictor_init.json``), read by :mod:`repro_torch.convert`."""
