"""The port's data pipeline: TFRecord files and the Example wire format,
the Python parser and pipeline, the native loader, and the input
generators that bind them (and random batches) to a model's specs."""
