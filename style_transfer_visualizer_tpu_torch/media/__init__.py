"""Host-side media: frame sinks, the frame stream, encoders, segments."""
