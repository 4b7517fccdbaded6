from .reader import VCF, VCFRecord
from .scan import scan_vcf_sample, ScanResult

__all__ = ["VCF", "VCFRecord", "scan_vcf_sample", "ScanResult"]
