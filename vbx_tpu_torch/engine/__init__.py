"""The batched VB-HMM engine and the diarization pipeline built around it
(AHC / random initialization, label post-processing)."""
