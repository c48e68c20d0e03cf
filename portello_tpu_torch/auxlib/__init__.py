"""Library-parity auxiliary components not used by the liftover binary itself
(reference SURVEY.md section 2c): base-modification decoding, etc."""
