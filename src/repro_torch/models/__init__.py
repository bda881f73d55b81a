"""Models of the port: dense-family building blocks (``layers``), the paged
decoder LM (``model``), the engine's runner contract (``runner``) and the
JAX-parameter converter (``convert``)."""
