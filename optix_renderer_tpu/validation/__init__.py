"""Statistical validation layer: executable <test> scene objects.

The counterpart of the reference's signature validation mechanism —
ttest/chi2test registered as scene objects that run when their XML is loaded
(src/utils/ttest.cpp:60-270, src/utils/chi2test.cpp:43-270, SURVEY.md §4.1).
"""

from optix_renderer_tpu.validation.xmltest import run_xml_test  # noqa: F401
