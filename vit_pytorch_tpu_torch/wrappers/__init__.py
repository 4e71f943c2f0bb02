"""Introspection wrappers, port of ``vit_pytorch_tpu/wrappers/``:
``recorder.Recorder`` (the attention maps), ``extractor.Extractor`` (a
layer's embeddings) and ``accept_video_wrapper.AcceptVideoWrapper`` (an
image network over video frames)."""
