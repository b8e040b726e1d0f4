"""Part 1 of the matching (the substream_match kernel): entry point
``ops.substream_match``, kernel binding ``kernel``, plain versions ``ref``."""
