"""repro_torch.train: training of the language models (port of
``repro.train``): AdamW with clipping and the cosine schedule
(``optimizer``), error-feedback int8 gradient compression
(``compression``), the synthetic token pipeline drawn from the reference's
threefry stream (``data``), and the family-dispatched loss and train step
(``step``), gradients by torch autograd through the plain route.
``launch.train`` drives them end to end with checkpoint/restart."""
